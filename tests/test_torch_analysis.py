"""The port's static-analysis layer against the reference's
(``repro_torch.analysis`` vs ``repro.analysis``; ``tests/test_analysis.py``
is the reference's own).

Three layers under test:

* ``analysis.record`` — the collective recorder that stands for the
  reference's HLO parser: per-op kind, dtype, payload and wire bytes, the
  async handle, the fake-group emulation, the outputs' dtype signature and
  the reference-shaped ``summarize`` dict;
* ``analysis.audit`` — the generated spec lattice is deterministic, has the
  reference's 84 specs on 8 ranks and covers every registered plan family;
  every cell's model is the reference's own pure volume function for the
  same spec; the sweep on a fake process group of 8 ranks has zero
  findings; and the auditor HARD-FAILS on a missing collective, a broken
  volume model, a narrowed verdict all-reduce, a downcast output and a
  checked-GEMM flop count off its model;
* ``analysis.lint`` — each rule fires on the same lines of a torch-idiom
  tree as the reference's rule on the same tree in its own idiom, the
  restated L004 on a synthetic runtime, ``# noqa``, the baseline round
  trip, and the real tree (only the two ``kernels/ref.py`` L002 findings,
  grandfathered).

Everything that needs the fake process group runs in ONE subprocess for
the file (``_SWEEP``): the lattice twice, the sweep, the two negative cells
that issue collectives and the CLI. The rest runs here.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist

from repro.analysis import lint as ref_lint
from repro.core.fft import distributed as ref_dist
from repro.core.fft import multidim as ref_md
from repro_torch.analysis import audit, lint, record as rec
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.core.fft import distributed as tdist
from repro_torch.core.fft.api import FFTSpec
from repro_torch.core.gemm.api import GEMMPlan, GEMMSpec
from repro_torch.core.plan import FTConfig

REPO = pathlib.Path(__file__).resolve().parents[1]

# ---------------------------------------------------------------------------
# the one subprocess: everything on the fake process group
# ---------------------------------------------------------------------------

_SWEEP = textwrap.dedent("""\
    import contextlib, io, json
    import torch
    import torch.distributed as dist
    from repro_torch.analysis import audit
    from repro_torch.analysis.__main__ import main
    from repro_torch.core.fft import distributed as tdist
    from repro_torch.core.fft.api import FFTSpec
    from repro_torch.core.plan import plan, plan_cache_clear
    from repro_torch.core import plan as planbase

    out = {}
    reprs = []
    for _ in range(2):
        with audit.fake_meshes(8) as meshes:
            reprs.append([repr(s) for s in audit.lattice(meshes)])
    out["reprs"] = reprs
    cells = []
    with audit.fake_meshes(8) as meshes:
        specs = audit.lattice(meshes)
        out["types"] = sorted({type(s).__name__ for s in specs})
        out["registered"] = sorted(c.__name__ for c in planbase._PLAN_TYPES)
        rep = audit.audit_specs(specs, strict=False)
        out["specs"], out["n_cells"] = rep.specs, len(rep.cells)
        out["families"] = sorted(rep.by_family())
        out["findings"] = [str(f) for f in rep.findings]
        for s in specs:
            if not isinstance(s, FFTSpec):
                continue
            p = plan(s)
            for c in audit.audit_plan(p, strict=False):
                cells.append({
                    "tag": c.tag, "model": c.model,
                    "counts": c.measured["count"],
                    "spec": {"shape": list(s.shape), "dtype": s.dtype,
                             "rank": s.rank, "real": s.real,
                             "natural_order": s.natural_order,
                             "chunks": s.chunks,
                             "groups": s.ft.groups if s.ft else None},
                    "plan": {"shards": p.shards, "dsize": p.dsize,
                             "decomp": p.decomp, "groups": p.groups,
                             "chunks": p.chunks, "sharded": p.sharded},
                    "ops": [[op.kind, op.dtypes[0], op.payload_bytes]
                            for op in c.collectives]})
        out["cells"] = cells
        # a broken volume model under the sweep
        real = tdist.collective_volume

        def broken(*a, **kw):
            v = dict(real(*a, **kw))
            v["hlo_bytes"] *= 2
            v["all_to_all_bytes"] *= 2
            return v

        tdist.collective_volume = broken
        plan_cache_clear()
        try:
            audit.audit_specs([FFTSpec(shape=(8, 256), mesh=meshes[0],
                                       device="cpu")], strict=True)
            out["broken"] = []
        except audit.AuditError as e:
            out["broken"] = sorted({f.check for f in e.findings})
        finally:
            tdist.collective_volume = real
            plan_cache_clear()
        # a verdict all-reduce narrowed to float32 under a complex128 spec
        group = meshes[0].get_group("fft")

        def narrowed(x):
            dist.all_reduce(torch.zeros(13, dtype=torch.float32),
                            group=group)
            return x

        model = {"all_to_all_count": 0, "all_gather_count": 0,
                 "psum_hlo": 2.0 * 13 * 4}
        rep = audit.check_cell(narrowed, (torch.zeros(4, 8,
                                                      dtype=torch.complex128),),
                               model, tag="narrow", dtype="complex128",
                               strict=False)
        out["narrowed"] = sorted({f.check for f in rep.findings})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["cli_rc"] = main(["--strict", "--min-specs", "84"])
    out["cli"] = buf.getvalue().splitlines()
    out["initialized_after"] = dist.is_initialized()
    print("RESULT " + json.dumps(out))
    """)


@pytest.fixture(scope="module")
def sweep():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _SWEEP], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_record_ops_async_and_wire_bytes():
    """Kind, async-ness, payload and wire bytes of each recorded op, in
    program order: the all-to-all's payload is its send buffer, the
    all-gather's its output, the all-reduce's wire twice its payload."""
    send = torch.arange(8 * 16, dtype=torch.float32).view(8, 16)
    send = torch.complex(send, -send)
    recv = torch.empty_like(send)
    small = torch.arange(4, dtype=torch.float64)
    gathered = torch.empty(8, dtype=torch.float64)
    with rec.record(emulate=True) as ops:
        work = dist.all_to_all_single(recv, send, async_op=True)
        assert work.wait()
        dist.all_gather_into_tensor(gathered, small)
        dist.all_reduce(torch.zeros(3, dtype=torch.float32))
        dist.all_reduce(torch.zeros((), dtype=torch.bool))
    assert [o.kind for o in ops] == ["all-to-all", "all-gather",
                                     "all-reduce", "all-reduce"]
    a2a = ops[0]
    assert a2a.is_async and not ops[1].is_async
    assert a2a.payload_bytes == 8 * 16 * 8
    assert a2a.wire_bytes == a2a.payload_bytes
    assert a2a.dtypes == ("c64",) and a2a.elems == 8 * 16
    assert ops[1].payload_bytes == 8 * 8 and ops[1].dtypes == ("f64",)
    assert ops[2].payload_bytes == 3 * 4
    assert ops[2].wire_bytes == 2.0 * 3 * 4
    assert ops[3].dtypes == ("pred",)
    # the emulation: the output is the input; a gather tiles it
    assert torch.equal(recv, send)
    assert torch.equal(gathered, small.repeat(2))


def test_record_restores_dist_and_nests():
    names = ("all_to_all_single", "all_gather_into_tensor", "all_reduce",
             "broadcast", "send", "recv")
    before = {n: getattr(dist, n) for n in names}
    with rec.record(emulate=True) as outer:
        dist.broadcast(torch.zeros(2), src=0)
        with rec.record(emulate=True) as inner:
            dist.all_reduce(torch.zeros(5))
        dist.all_reduce(torch.zeros(7))
    assert {n: getattr(dist, n) for n in names} == before
    assert [o.kind for o in inner] == ["all-reduce"]
    # the outer context records the inner's call too: its wrapper runs
    # under the inner's
    assert [o.kind for o in outer] == ["broadcast", "all-reduce",
                                       "all-reduce"]
    assert outer[0].wire_bytes == 2 * 4


def test_root_signature():
    assert rec.root_signature(
        (torch.zeros(2, dtype=torch.complex64), torch.zeros(()),
         torch.zeros(1, dtype=torch.bool))) == ("c64", "f32", "pred")

    @dataclasses.dataclass
    class Result:
        y: torch.Tensor
        stats: dict

    got = rec.root_signature(Result(torch.zeros(1, dtype=torch.complex128),
                                    {"s": torch.zeros(1, dtype=torch.int32)}))
    assert got == ("c128", "s32")
    assert rec.root_signature("no tensors here") == ()


def test_summarize_reference_shape():
    with rec.record(emulate=True) as ops:
        x = torch.zeros(8, 4096, dtype=torch.complex64)
        dist.all_to_all_single(torch.empty_like(x), x)
        dist.all_reduce(torch.zeros(3))
        dist.all_reduce(torch.zeros((), dtype=torch.bool))
    s = rec.summarize(ops)
    assert set(s) == {"bytes", "count", "ops", "total_bytes"}
    assert s["count"]["all-to-all"] == 1
    assert s["count"]["all-reduce"] == 2
    assert s["total_bytes"] == pytest.approx(8 * 4096 * 8
                                             + 2.0 * (3 * 4 + 1))
    assert [k for k, _ in s["ops"]] == ["all-to-all", "all-reduce",
                                        "all-reduce"]


# ---------------------------------------------------------------------------
# the plan auditor
# ---------------------------------------------------------------------------

def test_lattice_deterministic_with_the_reference_specs(sweep):
    """The lattice on 8 ranks is the same every run and has the
    reference's 84 specs (README "Static analysis")."""
    a, b = sweep["reprs"]
    assert a == b
    assert len(a) == sweep["specs"] == 84


def test_lattice_covers_every_registered_plan_family(sweep):
    assert sweep["types"] == sweep["registered"] == ["FFTSpec", "GEMMSpec"]


def test_audit_full_lattice_sweep(sweep):
    """The CI gate itself: every cell's recorded collectives match its
    model with zero findings."""
    assert sweep["findings"] == []
    assert sweep["n_cells"] >= sweep["specs"]
    assert {"fft1d", "fft2d", "fftr1d", "fftr2d", "gemm"} <= set(
        sweep["families"])


def _ref_volume(cell):
    """The reference's pure volume function for the cell's spec, its
    arguments resolved by the reference's own helpers."""
    s, p = cell["spec"], cell["plan"]
    itemsize = 16 if s["dtype"] == "complex128" else 8
    shape = tuple(s["shape"])
    batch = shape[0] if len(shape) > s["rank"] else 1
    tshape = shape[-s["rank"]:]
    shards, dd = p["shards"], p["dsize"]
    ft = s["groups"] is not None
    groups = (ref_dist.resolve_abft_groups(batch, groups=s["groups"],
                                           data_shards=dd) if ft else 1)
    dsz = dd if (dd > 1 and batch % dd == 0
                 and (not ft or groups % dd == 0)) else 1
    if cell["tag"].endswith(":spectral"):
        chunks = ref_dist.resolve_chunks(batch, s["chunks"])
        return ref_dist.spectral_volume(tshape[0], batch, shards,
                                        kernel_batch=1, itemsize=itemsize,
                                        chunks=chunks)
    if s["rank"] == 1:
        if s["real"]:
            return ref_dist.collective_volume(tshape[0], batch, shards,
                                              itemsize=itemsize,
                                              data_shards=dsz, real=True)
        rows = (groups if ft else batch) // dsz
        chunks = ref_dist.resolve_chunks(rows, s["chunks"])
        return ref_dist.collective_volume(
            tshape[0], batch, shards, itemsize=itemsize, ft=ft,
            natural_order=s["natural_order"], groups=groups,
            data_shards=dsz, chunks=chunks)
    if p["decomp"] == "slab":
        return ref_md.collective_volume_nd(
            tshape, batch, shards, decomp="slab", itemsize=itemsize, ft=ft,
            groups=groups, data_shards=dsz, natural_order=True,
            real=s["real"])
    lead = (batch,) + tshape[:-2]
    chunks = next((c for c in (ref_dist.resolve_chunks(n, s["chunks"])
                               for n in lead) if c > 1), 1)
    return ref_md.collective_volume_nd(
        tshape, batch, shards, decomp="pencil", itemsize=itemsize,
        data_shards=dd, natural_order=s["natural_order"], chunks=chunks)


def test_ft_wire_terms_are_the_recorded_pipelines(sweep):
    """``core.fft.distributed.ft_wire_terms``, the one statement of what
    the port's grouped ABFT moves besides its payload, is what every ft
    cell of the lattice recorded: the verdict all-reduces (calls, bytes)
    and the telemetry all-gathers of the spec's real dtype."""
    ft = [c for c in sweep["cells"]
          if c["model"] and c["model"].get("abft_overhead")]
    assert len(ft) >= 10
    for c in ft:
        m = c["model"]
        real = 8 if c["spec"]["dtype"] == "complex128" else 4
        rtoken = {4: "f32", 8: "f64"}[real]
        want = tdist.ft_wire_terms(m["groups"], m["shards"],
                                   data_shards=m["data_shards"],
                                   chunks=m.get("chunks", 1),
                                   real_itemsize=real)
        verdict = [n for kind, _, n in c["ops"] if kind == "all-reduce"]
        tele = [n for kind, dt, n in c["ops"]
                if kind == "all-gather" and dt == rtoken]
        assert (len(verdict), sum(verdict)) == (
            want["verdict_count"], want["verdict_bytes"]), c["tag"]
        assert (len(tele), sum(tele)) == (
            want["telemetry_count"], want["telemetry_bytes"]), c["tag"]


def test_every_cell_model_is_the_reference_volume(sweep):
    """Each sharded cell's model (the port's ``plan.volume`` or
    ``spectral_volume``) equals the reference's own pure volume function
    for the same spec — no JAX mesh needed; local cells have none."""
    sharded = [c for c in sweep["cells"] if c["plan"]["sharded"]]
    assert len(sharded) == 74 + 4       # 74 sharded specs + 4 spectral
    for c in sharded:
        want = _ref_volume(c)
        got = c["model"]
        assert set(got) == set(want), c["tag"]
        for k, v in want.items():
            if isinstance(v, tuple):
                v = list(v)
            assert got[k] == pytest.approx(v) if isinstance(
                v, float) else got[k] == v, (c["tag"], k)
    local = [c for c in sweep["cells"] if not c["plan"]["sharded"]]
    assert len(local) == 3 and all(c["model"] is None for c in local)


def test_audit_catches_broken_volume_model(sweep):
    """THE acceptance demonstration: a corrupted model under the sweep
    fails the spec."""
    assert set(sweep["broken"]) & {"all-to-all-bytes", "total-bytes"}


def test_check_cell_flags_narrowed_verdict(sweep):
    assert sweep["narrowed"] == ["psum-width"]


def test_cli_strict_exits_zero_on_the_lattice(sweep):
    """``python -m repro_torch.analysis --strict --min-specs 84``: exit 0,
    the reference's summary lines; the fake group is torn down."""
    assert sweep["cli_rc"] == 0
    assert sweep["cli"][0] == "lint: 0 new finding(s), 2 grandfathered"
    assert re.fullmatch(r"audit: 84 specs, 88 cells \(fft1d=42 fft2d=23 "
                        r"fft3d=4 fftr1d=4 fftr2d=8 gemm=7\), 0 finding\(s\)",
                        sweep["cli"][-1])
    assert sweep["initialized_after"] is False


def test_audit_local_and_gemm_plans_without_a_group():
    """The device-independent slice (a local FFT and the GEMM plans)
    audits clean with no process group: collective-free programs, exact
    flop model."""
    specs = [FFTSpec(shape=(8, 256), device="cpu"),
             GEMMSpec(shape=(64, 32, 48), backend="eager", device="cpu"),
             GEMMSpec(shape=(64, 32, 48), ft=FTConfig(), backend="eager",
                      device="cpu")]
    rep = audit.audit_specs(specs, strict=True)
    assert rep.specs == 3 and not rep.findings
    assert rep.cells[0].root == ("c64",)


def test_check_cell_flags_missing_collective():
    """A model that promises collectives a program does not have is a
    hard failure, not a warning."""
    x = torch.zeros(8, 64, dtype=torch.complex64)
    bad_model = {"all_to_all_count": 1, "all_gather_count": 0,
                 "hlo_bytes": 4096.0}
    with pytest.raises(audit.AuditError) as ei:
        audit.check_cell(lambda t: t + 1, (x,), bad_model, tag="t")
    checks = {f.check for f in ei.value.findings}
    assert {"all-to-all-count", "total-bytes"} <= checks
    # and a local plan contract: no collective, no finding
    rep = audit.check_cell(lambda t: t + 1, (x,), None, tag="t2",
                           strict=False)
    assert not rep.findings


@pytest.mark.parametrize("dtype,narrow", [("float64", torch.float32),
                                          ("complex128", torch.complex64)])
def test_check_cell_flags_output_downcast(dtype, narrow):
    x = torch.zeros(8, dtype=getattr(torch, dtype))
    with pytest.raises(audit.AuditError) as ei:
        audit.check_cell(lambda t: t.to(narrow), (x,), None, tag="t",
                         dtype=dtype)
    assert {f.check for f in ei.value.findings} == {"root-dtype"}


def test_audit_catches_checksum_flops_off_the_model():
    """A checked GEMM whose counted checksum flops fall outside [0.5x, 2x]
    of the model fails; the unchecked product's flops are 2MKN exactly."""
    spec = GEMMSpec(shape=(64, 32, 48), ft=FTConfig(), backend="eager",
                    device="cpu")
    p = GEMMPlan(spec)
    assert not audit.audit_plan(p, strict=False)[0].findings
    p.volume["checksum_flops"] *= 10
    with pytest.raises(audit.AuditError) as ei:
        audit.audit_plan(p)
    assert {f.check for f in ei.value.findings} == {"checksum-flops"}
    q = GEMMPlan(GEMMSpec(shape=(64, 32, 48), backend="eager",
                          device="cpu"))
    q.volume["flops"] += 1
    assert {f.check for f in audit.audit_plan(q, strict=False)[0]
            .findings} == {"flops"}


def test_ft_telemetry_is_held_exactly():
    """An ABFT cell whose telemetry gathers move other bytes than the
    pipeline's, or whose verdict all-reduce is short, fails: the port's
    reading of ``psum_hlo`` and ``permute_hlo`` loosens nothing."""
    model = ref_dist.collective_volume(256, 8, 2, itemsize=8, ft=True,
                                       groups=4, natural_order=False)
    real = 4
    verdict = (3 * 4 + 1) * real
    good = [rec._op("all-to-all", torch.zeros(
                int(model["all_to_all_bytes"]) // 8,
                dtype=torch.complex64), is_async=True, group_size=2),
            rec._op("all-reduce", torch.zeros(verdict // real),
                    is_async=False, group_size=2),
            rec._op("all-gather", torch.zeros(2), is_async=False,
                    group_size=2)]
    findings, _ = audit._diff("t", good, ("c64",), model, rtol=1e-3,
                              check_exposed=True, dtype="complex64")
    assert findings == []
    short = good[:1] + [rec._op("all-reduce", torch.zeros(3),
                                is_async=False, group_size=2)] + good[2:]
    findings, _ = audit._diff("t", short, ("c64",), model, rtol=1e-3,
                              check_exposed=True, dtype="complex64")
    assert {f.check for f in findings} == {"all-reduce-bytes",
                                           "total-bytes"}
    wide = good[:2] + [rec._op("all-gather", torch.zeros(3),
                               is_async=False, group_size=2)]
    findings, _ = audit._diff("t", wide, ("c64",), model, rtol=1e-3,
                              check_exposed=True, dtype="complex64")
    assert {f.check for f in findings} == {"telemetry"}


# ---------------------------------------------------------------------------
# repo lint: each rule on the same tree in both idioms
# ---------------------------------------------------------------------------

def _tree(tmp_path, files: dict) -> pathlib.Path:
    for rel, body in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(body))
    return tmp_path


def _rules(findings):
    return [f.rule for f in findings]


def _both(tmp_path, files_ref: dict, files_port: dict):
    """(reference findings on its tree, port findings on the torch one)."""
    ref = ref_lint.lint_tree(_tree(tmp_path / "ref", files_ref))
    port = lint.lint_tree(_tree(tmp_path / "port", files_port))
    return ref, port


def _where(findings):
    return [(f.rule, f.path.split("/", 2)[-1], f.line) for f in findings]


_L001 = """\
    from {pkg}.kernels import ops
    from {pkg}.kernels.ops import fft as kfft

    def f(x, mesh):
        a = ops.fft(x, mesh=mesh)            # positive: aliased module
        b = kfft(x, natural_order=False)     # positive: aliased entry
        c = ops.fft(x, bs=4)                 # negative: live kwarg
        d = ops.fft(x, mesh=mesh)  # noqa: L001
        e = ops.ft_fft(x, groups=4, group_size=2)   # positive: mesh knobs
        return a, b, c, d, e
"""


def test_lint_l001_deprecated_kwargs(tmp_path):
    ref, port = _both(
        tmp_path, {"src/repro/x.py": _L001.format(pkg="repro")},
        {"src/repro_torch/x.py": _L001.format(pkg="repro_torch")})
    assert _rules(port) == ["L001", "L001", "L001"]
    assert [f.line for f in port] == [5, 6, 9]
    assert _where(port) == _where(ref)
    assert "group_size, groups" in port[2].message


def test_lint_l002_raw_fft_scoped_to_core(tmp_path):
    ref_body = """\
        import jax.numpy as jnp

        def f(x):
            return jnp.fft.fft(x)
    """
    body = """\
        import torch

        def f(x):
            return torch.fft.fft(x)
    """
    aliased = """\
        from torch import fft as tfft
        import torch.fft

        def g(x):
            return tfft.ifft(x) + torch.fft.rfft(x).real
    """
    ref, port = _both(
        tmp_path,
        {"src/repro/kernels/a.py": ref_body,
         "src/repro/core/fft/b.py": ref_body,
         "benchmarks/c.py": ref_body},
        {"src/repro_torch/kernels/a.py": body,
         "src/repro_torch/core/fft/b.py": body,
         "benchmarks_torch/c.py": body})
    assert _rules(port) == ["L002"]
    assert port[0].path == "src/repro_torch/kernels/a.py"
    assert _where(port) == _where(ref)
    more = lint.lint_tree(_tree(tmp_path / "more",
                                {"src/repro_torch/models/m.py": aliased}))
    assert _rules(more) == ["L002", "L002"] and more[0].line == 5


_L003 = """\
    def f(n, shards):
        assert n % shards == 0       # positive: validates params
        local = n // shards
        assert local * shards == n   # positive: n is a param
        m = local + 1
        assert m > 0                 # negative: locals only
        return m
"""


def test_lint_l003_param_asserts(tmp_path):
    ref, port = _both(tmp_path, {"src/repro/v.py": _L003},
                      {"src/repro_torch/v.py": _L003})
    assert _rules(port) == ["L003", "L003"]
    assert _where(port) == _where(ref)


_L005 = """\
    class S:
        def __post_init__(self):
            object.__setattr__(self, "a", 1)   # ok

        def mutate(self):
            object.__setattr__(self, "a", 2)   # positive
"""


def test_lint_l005_frozen_setattr(tmp_path):
    ref, port = _both(tmp_path, {"src/repro/s.py": _L005},
                      {"src/repro_torch/s.py": _L005})
    assert _rules(port) == ["L005"]
    assert "mutate" in port[0].message
    assert _where(port) == _where(ref)


_RUNTIME = """\
    import threading

    from repro_torch.serve.specs import serve_plan


    class R:
        def __init__(self, mesh):
            self.channel = None
            if mesh is not None:
                self._start_mesh(mesh)
                return
            threading.Thread(target=self._worker_loop).start()

        def _start_mesh(self, mesh):
            self.channel = object()
            threading.Thread(target=self._lead).start()

        def admit(self, p, xb):
            if self.channel is not None:
                return self._admit_on_mesh(p)
            serve_plan(p, xb)                  # ok: no mesh channel here

        def _lead(self):
            self._run_all(self.p, self.xb)
            self._shared(self.p, self.xb)

        def _follow_loop(self):
            self._run_all(self.p, self.xb)

        def _run_all(self, p, xb):
            serve_plan(p, xb)                  # ok: only the dispatch threads

        def _worker_loop(self):
            serve_plan(self.p, self.xb)        # positive: a worker dispatches
            self._shared(self.p, self.xb)

        def _shared(self, p, xb):
            serve_plan(p, xb)                  # positive: a worker reaches it

        def _execute(self, p, xb):
            if self.channel is None:
                serve_plan(p, xb)              # ok: no mesh channel
            serve_plan(p, xb)  # noqa: L004
"""


def test_lint_l004_dispatch_off_the_dispatch_thread(tmp_path):
    """The restated L004: a worker that dispatches (or reaches a method
    that does) is flagged; the dispatch threads' methods and the
    no-channel branches are not."""
    root = _tree(tmp_path, {"src/repro_torch/serve/runtime.py": _RUNTIME})
    fs = lint.lint_tree(root)
    assert _rules(fs) == ["L004", "L004"]
    assert [f.line for f in fs] == [34, 38]
    # outside serve/runtime.py the rule does not run
    other = lint.lint_tree(_tree(tmp_path / "o", {
        "src/repro_torch/serve/other.py": _RUNTIME}))
    assert other == []


def test_lint_l004_real_runtime_sites(tmp_path):
    """On the port's runtime, the five ``serve_plan`` calls: the
    admission's two run only without a mesh channel, ``_admit_all``'s and
    ``_run_all``'s only on the dispatch thread, and the worker pool's
    carries its ``noqa`` with the reason above it; without that ``noqa``
    the rule flags it."""
    import ast

    path = REPO / "src/repro_torch/serve/runtime.py"
    source = path.read_text()
    text = source.splitlines()
    sites = sorted(n.lineno for n in ast.walk(ast.parse(source))
                   if isinstance(n, ast.Call)
                   and getattr(n.func, "id", None) == "serve_plan")
    assert len(sites) == 5
    noqa = [n for n in sites if "# noqa: L004" in text[n - 1]]
    assert len(noqa) == 1 and "worker pool" in text[noqa[0] - 3]
    assert [f for f in lint.lint_file(path, REPO) if f.rule == "L004"] == []
    text[noqa[0] - 1] = text[noqa[0] - 1].replace("  # noqa: L004", "")
    root = _tree(tmp_path, {"src/repro_torch/serve/runtime.py": ""})
    (root / "src/repro_torch/serve/runtime.py").write_text(
        "\n".join(text) + "\n")
    fs = lint.lint_tree(root)
    assert _rules(fs) == ["L004"] and fs[0].line == noqa[0]


def test_lint_real_tree_has_no_unbaselined_findings():
    """Acceptance: zero NEW lint findings in the port; the baseline holds
    only the plain reference's two ``torch.fft`` calls (one fingerprint:
    they share a line)."""
    new, old = lint.split_baseline(lint.lint_tree(), lint.load_baseline())
    assert new == []
    assert [(f.rule, f.path) for f in old] == \
        [("L002", "src/repro_torch/kernels/ref.py")] * 2
    assert lint.load_baseline() == {
        "L002|src/repro_torch/kernels/ref.py|y = torch.fft.ifft(x) if "
        "inverse else torch.fft.fft(x)"}
    assert [f for f in lint.lint_tree() if f.rule == "L003"] == []


def test_lint_baseline_roundtrip(tmp_path):
    root = _tree(tmp_path, {"src/repro_torch/v.py": """\
        def f(n):
            assert n > 0
    """})
    fs = lint.lint_tree(root)
    assert _rules(fs) == ["L003"]
    base = tmp_path / "baseline.txt"
    lint.save_baseline(fs, base)
    loaded = lint.load_baseline(base)
    assert loaded == {f.fingerprint for f in fs}
    new, old = lint.split_baseline(fs, loaded)
    assert new == [] and old == fs
    # fingerprints are line-number-free: prepending code must not
    # resurrect a grandfathered finding
    p = root / "src/repro_torch/v.py"
    p.write_text("import os\n\n\n" + p.read_text())
    new, old = lint.split_baseline(lint.lint_tree(root), loaded)
    assert new == [] and len(old) == 1


def test_cli_lint_only_strict_fails_on_a_new_finding(tmp_path, monkeypatch,
                                                     capsys):
    root = _tree(tmp_path, {"src/repro_torch/v.py": """\
        def f(n):
            assert n > 0
    """})
    assert cli_main(["--lint-only", "--strict"]) == 0
    real = lint.lint_tree
    monkeypatch.setattr(lint, "lint_tree", lambda: real(root))
    assert cli_main(["--lint-only", "--strict"]) == 1
    assert cli_main(["--lint-only"]) == 0
    out = capsys.readouterr().out
    assert "LINT NEW  src/repro_torch/v.py:2: L003" in out
    assert "rerun with --strict" in out


def test_lint_imports_only_the_stdlib():
    """The linter runs before the tree is importable: stdlib ``ast``
    only, nothing of ``repro_torch``."""
    import ast

    tree = ast.parse((REPO / "src/repro_torch/analysis/lint.py").read_text())
    mods = {a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert mods == {"__future__", "ast", "dataclasses", "pathlib", "re"}


_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)"
                        r"(\.|\s))", re.M)


def test_port_imports_no_jax_and_nothing_of_the_reference():
    """No module of the port, ``chip_smoke.py`` or the chip scripts
    imports ``jax`` or anything of ``repro``."""
    files = sorted((REPO / "src/repro_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", *sorted((REPO / "scripts").glob("*.py"))]
    assert len(files) > 80
    bad = [str(f.relative_to(REPO)) for f in files
           if _FORBIDDEN.search(f.read_text())]
    assert bad == []
    for name in ("analysis/__init__.py", "analysis/__main__.py",
                 "analysis/audit.py", "analysis/lint.py",
                 "analysis/record.py", "analysis/lint_baseline.txt",
                 "launch/dryrun.py", "configs/turbofft_bench.py"):
        assert (REPO / "src/repro_torch" / name).is_file(), name


def test_turbofft_bench_config_is_the_reference():
    from repro import configs as ref_configs
    from repro_torch import configs
    from repro_torch.core.ft import FTPolicy

    for get in ("get_config", "get_smoke_config"):
        got = getattr(configs, get)("turbofft")
        want = getattr(ref_configs, get)("turbofft")
        assert isinstance(got.ft, FTPolicy)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert configs.ARCHS == ref_configs.ARCHS
