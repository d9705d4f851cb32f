"""Plan auditor: run every reachable plan executor on one rank of a fake
process group, record its collectives, and diff them against the analytic
volume models. Host-only: the lattice's plans run on ``device="cpu"`` (the
kernels' plain versions), at small sizes.

The counterpart of the reference's ``repro/analysis/audit.py``. The
reference lowers each executor to HLO without executing data; the port has
no compiler to ask, so a cell *runs* the plan's pipeline on rank 0's local
shard of zeros, under :class:`~repro_torch.analysis.record.record`, on the
``(2,)``, ``(4,)``, ``(2, 2)`` and ``(2, 4)`` meshes of a fake process group
of 8 ranks (:func:`default_meshes`). The fake group has no peers: the
recorder sets each collective's output itself, so the values a cell
computes are not the transform's, but its collectives, their order,
dtypes and bytes are the rank's.

The paper's contracts (one all-to-all per 1-D transform, two for the
spectral round trip, the verdict's all-reduce, zero all-gathers in
transposed order, C transactions when chunked) are encoded in
``collective_volume`` / ``spectral_volume`` / ``collective_volume_nd``
(copies of the reference's) and the GEMM checksum-flop model. For each
cell this module checks:

* collective COUNTS per kind (any unexpected all-gather, broadcast, send
  or recv fails; the port has no reduce-scatter or collective-permute);
* per-kind BYTES against the model's ``all_to_all_bytes`` /
  ``gather_hlo`` / ``psum_hlo`` terms and the ``hlo_bytes`` total;
* the verdict all-reduce's WIDTH (it must carry the spec's real dtype —
  f32 for complex64, f64 for complex128; bool and int32 carry no mantissa
  and are exempt);
* the exposed-communication fraction of chunked pipelines: ``max/sum`` of
  the recorded all-to-all payloads is ``1/C``;
* the dtypes of an executor's outputs (a complex128 spec whose outputs
  carry complex64 silently downcast);
* the GEMM flop model, by ``torch.utils.flop_counter.FlopCounterMode`` on
  the eager product: unchecked == ``2MKN`` exactly; the checked overhead
  within [0.5x, 2x] of the four-GEMV ``checksum_flops`` model, the
  reference's own window (its counter, like this one, is not the model:
  ``FlopCounterMode`` counts the matrix products, here the checksum
  GEMVs, and none of the reductions).

Where the port's pipeline is built otherwise than the reference's compiled
program, the model's terms are read for what the port moves, and nothing
is loosened:

* the grouped ABFT (``ft``). The reference psums the verdict's ``3G/data +
  C`` scalars together with the (G, 5) stats broadcast (``psum_hlo = 2 *
  (verdict + stats)``) and permutes the stats across data shards
  (``permute_hlo``). The port's one all-reduce a transaction carries the
  verdict's scalars alone: every rank decodes the same summed payload into
  the same stats. Its telemetry goes by all-gathers of the spec's real
  dtype: one over ``fft`` of the D left-check residuals and, when the batch
  shards over ``data``, one over ``data`` of the (G/data, 5) stats and the
  residuals (``core.fft.distributed.ft_wire_terms`` states both, next to
  the pipeline). So the all-reduce is held to the verdict's share of
  ``psum_hlo`` exactly, the telemetry gathers (apart from the payload's
  complex all-gathers) to their count and bytes exactly, and the total to
  ``hlo_bytes`` with those two terms in place of ``psum_hlo`` and
  ``permute_hlo``.
* ``cost_analysis`` has no counterpart: the GEMM flops are counted as
  above.

Like the reference's (its cells lower the inner jitted pipelines), a cell
runs the executor on a plain tensor, so the public wrappers' one-off
ingest (``parallel.fft_sharding``'s ``distribute_tensor`` of a
``plan.shard``) is left out of the steady-state contract under test.
``chip_smoke.py`` calls :func:`check_cell` on the card's ranks for every
mesh call of its sharded phase, so the card run and this audit share one
checker.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.analysis import record as rec
from repro_torch.core.fft import distributed as dist_fft
from repro_torch.core.fft import multidim as md
from repro_torch.core.fft.api import FFTSpec
from repro_torch.core.gemm.api import GEMMSpec
from repro_torch.core.plan import FTConfig, plan as build_plan

__all__ = ["AuditError", "Finding", "CellReport", "AuditReport",
           "check_cell", "audit_plan", "audit_specs",
           "fft_lattice", "gemm_lattice", "lattice", "default_meshes",
           "run_audit", "fake_meshes", "DEVICES"]

DEVICES = 8          # the fake process group's ranks (the reference's lane)

_COMPLEX_TOKEN = {"complex64": "c64", "complex128": "c128"}
_REAL_TOKEN = {"complex64": "f32", "complex128": "f64",
               "float32": "f32", "float64": "f64"}
_COMPLEX_TOKENS = frozenset(("c64", "c128"))
_FLOAT_TOKENS = frozenset(("f64", "f32", "bf16", "f16"))
_UNMODELLED = ("broadcast", "send", "recv")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation in one audited cell."""

    tag: str
    check: str
    detail: str

    def __str__(self):
        return f"[{self.tag}] {self.check}: {self.detail}"


class AuditError(AssertionError):
    """Raised when an audited cell diverges from its analytic model."""

    def __init__(self, findings):
        self.findings = list(findings)
        super().__init__(
            "\n".join(str(f) for f in self.findings) or "audit failed")


@dataclasses.dataclass
class CellReport:
    """One executed cell vs one model: measured summary + findings."""

    tag: str
    measured: dict
    collectives: list
    model: dict | None
    root: tuple
    findings: list


@dataclasses.dataclass
class AuditReport:
    specs: int
    cells: list
    findings: list

    def by_family(self) -> dict:
        fam: dict = {}
        for c in self.cells:
            fam.setdefault(c.tag.split(":", 1)[0], []).append(c)
        return fam


def _run(fn, *args):
    """``fn(*args)`` under the recorder: (its outputs, its collectives)."""
    with rec.record() as ops:
        out = fn(*args)
    return out, ops


def _rel_off(got: float, want: float, rtol: float) -> bool:
    if want == 0:
        return got != 0
    return abs(got / want - 1.0) >= rtol


def _port_terms(model: dict, rtoken: str | None) -> dict:
    """What the port moves for ``model``'s terms (module docstring): the
    all-reduce's wire bytes, the telemetry gathers' count and bytes, and
    the total. A model without the ABFT (``abft_overhead`` 0 or absent)
    keeps its own ``psum_hlo``, no telemetry and ``hlo_bytes``."""
    if not model.get("abft_overhead") or rtoken is None:
        return {"psum": model.get("psum_hlo", 0.0), "tele_count": 0,
                "tele_bytes": 0.0, "total": model.get("hlo_bytes")}
    t = dist_fft.ft_wire_terms(model["groups"], model["shards"],
                               data_shards=model["data_shards"],
                               chunks=model.get("chunks", 1),
                               real_itemsize=rec.DTYPE_BYTES[rtoken])
    psum = rec.WIRE_FACTOR["all-reduce"] * t["verdict_bytes"]
    tele_bytes = float(t["telemetry_bytes"])
    total = (model["hlo_bytes"] - model["psum_hlo"]
             - model.get("permute_hlo", 0.0) + psum + tele_bytes)
    return {"psum": psum, "tele_count": t["telemetry_count"],
            "tele_bytes": tele_bytes, "total": total}


def _diff(tag, ops, root, model, *, rtol, check_exposed, dtype=None):
    """All findings for one cell (pure function of recorded artifacts)."""
    meas = rec.summarize(ops)
    ctoken = _COMPLEX_TOKEN.get(dtype)
    rtoken = _REAL_TOKEN.get(dtype)
    terms = _port_terms(model, rtoken) if model is not None else None
    # an ABFT cell's telemetry gathers carry reals; the payload's, complex
    tele = [op for op in ops if terms is not None and terms["tele_count"]
            and op.kind == "all-gather" and op.dtypes != (ctoken,)]
    pay = rec.summarize([op for op in ops if op not in tele])
    count, by_kind = pay["count"], pay["bytes"]
    f = []

    def bad(check, detail):
        f.append(Finding(tag=tag, check=check, detail=detail))

    if model is None:
        # a local plan: the program must be collective-free, full stop
        for kind, c in meas["count"].items():
            if c:
                bad("unexpected-collective",
                    f"local plan issued {c} {kind} op(s)")
    else:
        if "all_to_all_count" in model \
                and count["all-to-all"] != model["all_to_all_count"]:
            bad("all-to-all-count",
                f"recorded={count['all-to-all']} "
                f"model={model['all_to_all_count']}")
        want_ag = int(model.get("all_gather_count", 0))
        if count["all-gather"] != want_ag:
            bad("all-gather-count",
                f"recorded={count['all-gather']} model={want_ag}"
                + (" (unexpected all-gather)"
                   if count["all-gather"] > want_ag else ""))
        for kind in _UNMODELLED:
            if count[kind]:
                bad("unexpected-collective",
                    f"{count[kind]} {kind} op(s); no pipeline models any")
        for kind, key, want in (
                ("all-to-all", "all_to_all_bytes",
                 model.get("all_to_all_bytes")),
                ("all-gather", "gather_hlo", model.get("gather_hlo")),
                ("all-reduce", "psum_hlo", terms["psum"])):
            if want is not None and _rel_off(by_kind[kind], want, rtol):
                bad(f"{kind}-bytes",
                    f"recorded={by_kind[kind]:.0f}B model={want:.0f}B")
        if terms["tele_count"] != len(tele) or _rel_off(
                sum(op.wire_bytes for op in tele), terms["tele_bytes"],
                rtol):
            bad("telemetry",
                f"recorded {len(tele)} gather(s) of "
                f"{sum(op.wire_bytes for op in tele):.0f}B, the pipeline's "
                f"{terms['tele_count']} of {terms['tele_bytes']:.0f}B")
        if terms["total"] is not None and _rel_off(
                meas["total_bytes"], terms["total"], rtol):
            bad("total-bytes", f"recorded={meas['total_bytes']:.0f}B "
                               f"model={terms['total']:.0f}B")
        if check_exposed and "exposed_fraction" in model \
                and count["all-to-all"]:
            a2a = [w for k, w in meas["ops"] if k == "all-to-all"]
            exposed = max(a2a) / sum(a2a)
            if abs(exposed - model["exposed_fraction"]) >= 1e-9:
                bad("exposed-fraction",
                    f"recorded={exposed:.6f} "
                    f"model={model['exposed_fraction']:.6f}")

    if dtype is not None:
        for op in ops:
            if op.kind == "all-reduce" and rtoken is not None:
                # the verdict's width: f32 scalars under a complex128 spec
                # would halve the detection mantissa; bool flags and int32
                # locations carry none and are exempt
                wrong = set(op.dtypes) - {rtoken, "pred", "s32"}
                if wrong:
                    bad("psum-width", f"all-reduce carries {sorted(wrong)}, "
                                      f"spec wants {rtoken}")
            elif op.kind in ("all-to-all", "all-gather") \
                    and ctoken is not None:
                want = rtoken if op in tele else ctoken
                wrong = set(op.dtypes) - {want}
                if wrong:
                    bad("collective-dtype",
                        f"{op.kind} carries {sorted(wrong)}, "
                        f"spec wants {want}")
        token = _COMPLEX_TOKEN.get(dtype) or _REAL_TOKEN.get(dtype)
        fam = _COMPLEX_TOKENS if token in _COMPLEX_TOKENS else _FLOAT_TOKENS
        present = set(root) & fam
        if root and (token not in present or present - {token}):
            bad("root-dtype",
                f"outputs carry {sorted(present) or ['none']} "
                f"of family {sorted(fam)}, spec wants {token}")
    return f, meas


def check_cell(fn, args, model, *, tag: str, rtol: float = 1e-3,
               check_exposed: bool = False, dtype: str | None = None,
               strict: bool = True, ops=None, out=None) -> CellReport:
    """Run one executor on ``args`` under the recorder and diff it against
    ``model``.

    This is the shared cell checker: the lattice sweep and
    ``chip_smoke.py``'s sharded phase both call it, so a model == recorded
    assertion can only live here. ``model=None`` asserts a collective-free
    program (local plans). ``dtype`` (a spec dtype string) additionally
    checks collective widths and the outputs' dtypes. A caller that ran
    the executor under its own :class:`~repro_torch.analysis.record
    .record` passes ``fn=None`` with the recorded ``ops`` and the call's
    ``out``. Raises :class:`AuditError` with every finding when
    ``strict``."""
    if fn is not None:
        out, ops = _run(fn, *args)
    root = rec.root_signature(out)
    findings, meas = _diff(tag, ops, root, model, rtol=rtol,
                           check_exposed=check_exposed, dtype=dtype)
    report = CellReport(tag=tag, measured=meas, collectives=list(ops),
                        model=model, root=root, findings=findings)
    if strict and findings:
        raise AuditError(findings)
    return report


# ---------------------------------------------------------------------------
# per-plan audit cells
# ---------------------------------------------------------------------------

def _spec_tag(spec, p) -> str:
    if isinstance(spec, GEMMSpec):
        m, k, n = spec.shape
        return (f"gemm:{m}x{k}x{n}_{spec.dtype}_{p.backend}"
                + ("_ft" if spec.ft else ""))
    mesh = "local" if not p.sharded else "x".join(
        f"{a}{n}" for a, n in zip(p.mesh.mesh_dim_names, p.mesh.shape))
    return (f"fft{'r' if spec.real else ''}{spec.rank}d:"
            f"{'x'.join(map(str, spec.shape))}_{spec.dtype}_{p.decomp}"
            f"_{mesh}"
            + ("_nat" if spec.natural_order else "_t")
            + (f"_g{p.groups}" if spec.ft else "")
            + (f"_c{p.chunks}" if p.chunks > 1 else ""))


def _zeros(shape, dtype, device):
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def _fft_cells(p):
    """(tag, fn, args, model, check_exposed, rtol) cells for one FFTPlan.

    Each cell runs the executor the plan binds on a plain tensor of
    zeros: rank 0's shard of its pipeline, without the one-off ingest of
    a DTensor operand (module docstring)."""
    spec, ft = p.spec, p.spec.ft
    tag = _spec_tag(spec, p)
    dev = p.device
    if spec.real:
        x = _zeros(spec.shape, p._rdtype, dev)
        if p.rank == 1:
            if p.decomp != "pencil":
                return []
            # the packed half-length C2C is the executed transform
            return [(tag + ":fwd", p.rfft, (x,), p.volume, False, 1e-3)]
        if p.decomp != md.DECOMP_SLAB:
            return []      # composed pencil real: no single nd model
        fn = p.ft_fft if ft is not None else p.rfft2
        return [(tag + ":fwd", fn, (x,), p.volume, False, 1e-3)]

    x = _zeros(spec.shape, spec.torch_dtype, dev)
    if not p.sharded:
        return [(tag + ":fwd", p.fft, (x,), None, False, 1e-3)]
    if p.rank == 1:
        fn = p.ft_fft if ft is not None else p.fft
        cells = [(tag + ":fwd", fn, (x,), p.volume, True, 1e-3)]
        # transposed-order non-ft plans feed the spectral round trip: audit
        # it against spectral_volume too (2C a2a, 0 gathers). Kernel-batch
        # 1 rides transaction 0, so the exposed-fraction identity does not
        # apply, and the reference's 2e-3 tolerance stays
        b, n = max(p.batch, 1), p.tshape[0]
        if ft is None and not spec.natural_order and p.daxis is None \
                and b % (p.shards * p.chunks) == 0:
            m = p._mesh_view()

            def spectral(a, v):
                return dist_fft._spectral_round_trip(
                    a, v, p.spectral_pencil, m, conj_kernel=False,
                    chunks=p.chunks)[0]

            smodel = dist_fft.spectral_volume(
                n, b, p.shards, kernel_batch=1,
                itemsize=spec.torch_dtype.itemsize, chunks=p.chunks)
            cells.append((tag + ":spectral", spectral,
                          (x, _zeros((1, n), spec.torch_dtype, dev)),
                          smodel, False, 2e-3))
        return cells
    if p.decomp == md.DECOMP_SLAB:
        fn = p.ft_fft if ft is not None else p.fft
        return [(tag + ":fwd", fn, (x,), p.volume, False, 1e-3)]
    return [(tag + ":fwd", p.fft, (x,), p.volume, False, 1e-3)]


def _audit_gemm(p, *, strict=True):
    from torch.utils.flop_counter import FlopCounterMode

    spec = p.spec
    tag = _spec_tag(spec, p)
    m, k, n = spec.shape
    gen = torch.Generator().manual_seed(0)
    dt = getattr(torch, spec.dtype)
    x = torch.randn((m, k), generator=gen, dtype=dt).to(p.device)
    w = torch.randn((k, n), generator=gen, dtype=dt).to(p.device)
    fn = p.ft_matmul if spec.ft is not None else p.matmul
    with FlopCounterMode(display=False) as counter:
        out, ops = _run(fn, x, w)
    root = rec.root_signature(out)
    findings, meas = _diff(tag, ops, root, None, rtol=1e-3,
                           check_exposed=False, dtype=spec.dtype)
    flops = float(counter.get_total_flops())
    want = float(p.volume["flops"])
    if spec.ft is None:
        if _rel_off(flops, want, 1e-6):
            findings.append(Finding(tag, "flops",
                                    f"counted={flops:.0f} model={want:.0f}"))
    else:
        # the counter sees the checksum GEMVs on top of the product, the
        # model the four GEMVs and the strips: gate the counted overhead
        # to [0.5x, 2x] of checksum_flops, the reference's window — wide
        # enough for the counter, tight enough to catch a broken or
        # missing model
        extra = flops - want
        cs = float(p.volume["checksum_flops"])
        if not (0.5 * cs <= extra <= 2.0 * cs):
            findings.append(Finding(
                tag, "checksum-flops",
                f"counted overhead={extra:.0f} model={cs:.0f} "
                f"(allowed [{0.5 * cs:.0f}, {2 * cs:.0f}])"))
    report = CellReport(tag=tag, measured=meas, collectives=ops,
                        model=p.volume, root=root, findings=findings)
    if strict and findings:
        raise AuditError(findings)
    return [report]


def audit_plan(p, *, strict: bool = True) -> list[CellReport]:
    """Audit every cell of one built plan. ``strict`` raises on the first
    cell with findings; otherwise findings accumulate on the reports."""
    if isinstance(p.spec, GEMMSpec):
        return _audit_gemm(p, strict=strict)
    reports = []
    for tag, fn, args, model, exposed, rtol in _fft_cells(p):
        reports.append(check_cell(fn, args, model, tag=tag, rtol=rtol,
                                  check_exposed=exposed,
                                  dtype=p.spec.dtype, strict=strict))
    return reports


# ---------------------------------------------------------------------------
# the spec lattice
# ---------------------------------------------------------------------------

def default_meshes(ndev: int | None = None, *, device: str = "cpu"):
    """Deterministic mesh templates over the first ``ndev`` ranks of the
    initialised process group (its world size by default), in the
    reference's order: 1-D ``(fft,)`` meshes of 2 and 4 shards plus 2-D
    ``data x fft`` meshes — ``(2, 2)`` from 4 ranks, ``(2, 4)`` from 8.
    Host-only by default (``device="cpu"``)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_fft_mesh

    if ndev is None:
        ndev = dist.get_world_size()
    out = []
    for data, shards in ((1, 2), (1, 4), (2, 2), (2, 4)):
        if data * shards <= ndev:
            out.append(make_fft_mesh(shards, data, device=device))
    return out


def _mesh_device(mesh) -> str:
    return getattr(mesh, "device_type", "cpu")


def fft_lattice(meshes, *, device: str = "cpu") -> list[FFTSpec]:
    """Every audited FFT configuration: rank x decomp x real x ft/groups x
    chunks x dtype x mesh, at small sizes so the sweep runs fast: the
    reference's lattice, spec for spec, on ``device``. Purely
    deterministic in ``meshes`` — the CI gate audits the same lattice
    every run. A spec listed here MUST plan."""
    specs: list[FFTSpec] = []
    g = FTConfig(groups=4)
    b, n = 8, 256
    for mesh in meshes:
        kw = dict(mesh=mesh, device=_mesh_device(mesh))
        for nat in (True, False):
            for chunks in (1, 2):
                specs.append(FFTSpec(shape=(b, n), natural_order=nat,
                                     chunks=chunks, **kw))
        specs.append(FFTSpec(shape=(b, n), dtype="complex128", **kw))
        specs.append(FFTSpec(shape=(b, n), ft=g, **kw))
        specs.append(FFTSpec(shape=(b, n), ft=g, natural_order=False,
                             chunks=2, **kw))
        specs.append(FFTSpec(shape=(b, n), dtype="complex128", ft=g, **kw))
        # rank-1 real: the packed half-length transform (natural only)
        specs.append(FFTSpec(shape=(b, 2 * n), real=True, **kw))
        # rank-2 slab + real slab (+ ft)
        specs.append(FFTSpec(shape=(b, 32, 64), rank=2, decomp="slab", **kw))
        specs.append(FFTSpec(shape=(b, 32, 64), rank=2, decomp="slab", ft=g,
                             **kw))
        specs.append(FFTSpec(shape=(b, 32, 64), rank=2, decomp="slab",
                             real=True, **kw))
        # rank-2 pencil, both orders (64 >= fft^2, 64 >= data^2)
        for nat in (True, False):
            specs.append(FFTSpec(shape=(b, 64, 64), rank=2, decomp="pencil",
                                 natural_order=nat, **kw))
        if mesh.mesh.dim() > 1:
            # chunked pencil on the 2-D mesh (replicated batch rows split)
            specs.append(FFTSpec(shape=(b, 64, 64), rank=2, decomp="pencil",
                                 natural_order=False, chunks=2, **kw))
        else:
            # deeper lattice on the 1-D meshes: fp64 slab ft, real ft,
            # the ungrouped ABFT, rank-3 pencil both orders
            specs.append(FFTSpec(shape=(b, 32, 64), rank=2,
                                 dtype="complex128", decomp="slab", ft=g,
                                 **kw))
            specs.append(FFTSpec(shape=(b, 32, 64), rank=2, decomp="slab",
                                 real=True, ft=g, **kw))
            g1 = FTConfig(groups=1)
            specs.append(FFTSpec(shape=(b, n), ft=g1, **kw))
            specs.append(FFTSpec(shape=(b, n), dtype="complex128", ft=g1,
                                 **kw))
            specs.append(FFTSpec(shape=(b, 32, 64), rank=2, decomp="slab",
                                 ft=g1, **kw))
            specs.append(FFTSpec(shape=(b, 32, 64), rank=2, decomp="slab",
                                 real=True, ft=g1, **kw))
            for nat in (True, False):
                specs.append(FFTSpec(shape=(4, 16, 16, 64), rank=3,
                                     decomp="pencil", natural_order=nat,
                                     **kw))
    # local plans: collective-free by contract
    specs.append(FFTSpec(shape=(b, n), device=device))
    specs.append(FFTSpec(shape=(b, n), dtype="complex128", device=device))
    specs.append(FFTSpec(shape=(b, 32, 64), rank=2, device=device))
    return specs


def gemm_lattice(*, device: str = "cpu") -> list[GEMMSpec]:
    """Checked and unchecked GEMMs on the eager backend (the reference's
    ``"xla"``: the host has no kernel)."""
    specs = []
    for shape in ((64, 32, 48), (128, 64, 32), (32, 128, 64)):
        for ft in (None, FTConfig()):
            specs.append(GEMMSpec(shape=shape, ft=ft, backend="eager",
                                  device=device))
    specs.append(GEMMSpec(shape=(64, 64, 64), dtype="float64",
                          backend="eager", device=device))
    return specs


def lattice(meshes=None, *, device: str = "cpu") -> list:
    """The FFT lattice over ``meshes`` (:func:`default_meshes` of the
    initialised process group when None) and the GEMM lattice."""
    if meshes is None:
        meshes = default_meshes(device=device)
    return fft_lattice(meshes, device=device) + gemm_lattice(device=device)


def audit_specs(specs, *, strict: bool = True,
                progress=None) -> AuditReport:
    """Plan + audit every spec. With ``strict`` the first divergent cell
    raises :class:`AuditError`; otherwise all findings are collected."""
    cells: list[CellReport] = []
    findings: list[Finding] = []
    for s in specs:
        p = build_plan(s)
        reports = audit_plan(p, strict=strict)
        cells.extend(reports)
        for r in reports:
            findings.extend(r.findings)
        if progress is not None:
            progress(s, reports)
    return AuditReport(specs=len(specs), cells=cells, findings=findings)


def run_audit(*, meshes=None, strict: bool = True, progress=None,
              devices: int = DEVICES, device: str = "cpu") -> AuditReport:
    """Audit the full generated lattice: over ``meshes`` of the caller's
    process group, or over :func:`default_meshes` of a fake process group
    of ``devices`` ranks that the audit sets up and tears down (the
    caller's group, when one exists, is used and left standing).
    Host-only by default (``device="cpu"``)."""
    if meshes is not None:
        return audit_specs(lattice(meshes, device=device), strict=strict,
                           progress=progress)
    with fake_meshes(devices, device=device) as ms:
        return audit_specs(lattice(ms, device=device), strict=strict,
                           progress=progress)


@contextlib.contextmanager
def fake_meshes(devices: int = DEVICES, *, device: str = "cpu"):
    """``with fake_meshes(8) as meshes:`` :func:`default_meshes` over a
    fake process group of ``devices`` ranks (or over the caller's group,
    left standing). Leaving a group the audit made drops the plans built on
    its meshes from the plan cache."""
    import torch.distributed as dist

    from repro_torch.core.plan import plan_cache_clear

    owned = not dist.is_initialized()
    with rec.fake_process_group(devices):
        try:
            yield default_meshes(devices, device=device)
        finally:
            if owned:
                plan_cache_clear()
