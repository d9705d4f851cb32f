"""The port's LM serving path (``repro_torch.launch.serve.decode``, the
serve and prefill step factories, ``--mode lm``) against the reference
``repro.launch.serve`` on the CPU, with the reference's own initialised
params carried across by ``params_from_numpy`` and the same prompts: the
dense decoder family, the recurrent models (their states carried through
every step) and the MoE models (DeepSeek-V3 with MLA's latent cache,
Llama-4 Maverick).

Greedy tokens are compared for equality: at float32 the two paths' logits
agree to about 1e-6 relative (``tests/test_torch_models.py``), far inside
the gaps between the top logits of these runs. With the CLI's two-entry
``FaultSchedule`` each entry faults its site in every block (each block
builds its own fault context), so the ledger is entries x layers in both
packages, and every fault is corrected: the tokens are the clean run's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.configs.base import RunConfig as RefRunConfig
from repro.core.ft import FaultSchedule as RefFaultSchedule
from repro.launch import serve as ref_launch
from repro.models import Model as RefModel
from repro.train import make_prefill_step as ref_make_prefill_step

from repro_torch import configs
from repro_torch.configs.base import RunConfig
from repro_torch.launch import serve as launch
from repro_torch.models import Model, params_from_numpy
from repro_torch.train import make_prefill_step

CPU = "cpu"
B, P, GEN = 2, 6, 8


def _setup(arch, dtype="float32", protect=False):
    """(port model, params), (reference model, params), prompts of
    ``arch``'s SMOKE size, the reference's params carried across."""
    pc = dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype)
    rc = dataclasses.replace(ref_configs.get_smoke_config(arch), dtype=dtype)
    if protect:
        pc = dataclasses.replace(pc, ft=dataclasses.replace(
            pc.ft, protect_linears=True, threshold=1e-3))
        rc = dataclasses.replace(rc, ft=dataclasses.replace(
            rc.ft, protect_linears=True, threshold=1e-3))
    rp = RefModel(rc).init(jax.random.PRNGKey(0))
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), device=CPU)
    prompts = np.random.default_rng(0).integers(0, pc.vocab_size, (B, P))
    return ((Model(pc), pp), (RefModel(rc), rp),
            (torch.as_tensor(prompts, dtype=torch.int32),
             jnp.asarray(prompts, jnp.int32)))


@pytest.mark.parametrize("arch", ["phi4_mini_3p8b", "gemma3_1b",
                                  "xlstm_350m", "recurrentgemma_2b",
                                  "deepseek_v3_671b", "llama4_maverick"])
def test_decode_tokens_match_reference(arch):
    (pm, pp), (rm, rp), (tp, tr) = _setup(arch)
    got = launch.decode(pm, pp, tp, GEN)
    want = ref_launch.decode(rm, rp, tr, GEN)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_fault_ledger_matches_reference():
    """The CLI's schedule (site 0 mid-prefill, site 1 mid-generation): the
    detected and corrected counts are entries x layers in both packages,
    and the tokens are the clean protected run's."""
    _check_fault_ledger("phi4_mini_3p8b")


@pytest.mark.parametrize("arch", ["xlstm_350m", "recurrentgemma_2b"])
def test_recurrent_decode_fault_ledger_matches_reference(arch):
    """The same on the recurrent models: sites 0 and 1 are each block's
    first two protected products (``w_in_gate``, ``w_in_rec`` of an
    RG-LRU block, q and k of a local-attention block; ``w_up``, ``wq`` of
    an mLSTM block, ``w_i``, ``w_f`` of an sLSTM block), and the corrected
    products leave the carried states those of the clean run."""
    _check_fault_ledger(arch)


@pytest.mark.parametrize("arch", ["deepseek_v3_671b", "llama4_maverick"])
def test_moe_decode_fault_ledger_matches_reference(arch):
    """The same on the MoE models: sites 0 and 1 are ``wq_a`` and ``wq_b``
    of an MLA block (DeepSeek), q and k of an attention block (Llama-4);
    the routed experts' checked products take no site, so the ledger is
    2 x layers, and every corrected product leaves the routing that of
    the clean run."""
    _check_fault_ledger(arch)


def _check_fault_ledger(arch):
    (pm, pp), (rm, rp), (tp, tr) = _setup(arch, protect=True)
    sched = launch.demo_schedule(B, P)
    ref_sched = RefFaultSchedule(entries=sched.entries)
    clean = launch.decode(pm, pp, tp, GEN)
    got, stats = launch.decode(pm, pp, tp, GEN, schedule=sched)
    want, ref_stats = ref_launch.decode(rm, rp, tr, GEN, schedule=ref_sched)
    layers = configs.get_smoke_config(arch).num_layers
    assert sched.num_faults == 2
    for key in ("detected", "corrected"):
        assert float(getattr(stats, key)) == \
            float(getattr(ref_stats, key)) == 2 * layers, key
    np.testing.assert_array_equal(got.numpy(), clean.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_step_matches_reference():
    (pm, pp), (rm, rp), (tp, tr) = _setup("qwen15_110b")
    got, _ = make_prefill_step(pm, RunConfig(model=pm.cfg))(
        pp, {"tokens": tp})
    want, _ = ref_make_prefill_step(rm, RefRunConfig(model=rm.cfg))(
        rp, {"tokens": tr})
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def _cli_lines(out: str) -> list[str]:
    """The CLI's lines without the timing of its ``generated`` line."""
    return [re.sub(r" in \S+s \(\S+ tok/s\)", "", ln)
            for ln in out.strip().splitlines()]


@pytest.mark.parametrize("ft", [False, True], ids=["clean", "ft"])
def test_cli_lm_mode_matches_reference(ft, capsys, monkeypatch):
    """``--mode lm --preset tiny`` at the CLI's defaults (Gemma-3 SMOKE,
    bf16 activations, batch 4, prompt 16, gen 32) prints the reference
    CLI's tokens and, with ``--ft``, its ledger (2 entries x 7 layers),
    when it runs on the reference's params (JAX's PRNG draws them; the port
    draws its own from a torch generator, so the test hands them across).

    At bfloat16 a greedy token can flip where a step's top two logits lie
    within the packages' rounding noise (about 1.5% of max|logits| here;
    the reference's jitted step differs from its own eager step there):
    the default run has no such step, while a run at batch 2, prompt 4,
    gen 6 has one (row 1's first generated token, a gap of 0.004). The
    float32 comparisons above hold every token."""
    got, want = _cli_both(["--ft"] if ft else [], capsys, monkeypatch)
    assert got == want
    assert got[0] == "generated (4, 32)"
    if ft:
        assert re.search(r"detected=14 corrected=14", got[1]), got[1]


@pytest.mark.parametrize("ft", [False, True], ids=["clean", "ft"])
def test_cli_lm_mode_recurrentgemma_matches_reference(ft, capsys,
                                                      monkeypatch):
    """``--mode lm --arch recurrentgemma-2b --preset tiny`` (RecurrentGemma
    SMOKE: RG-LRU and local-attention blocks; batch 4, prompt 16, gen 32)
    prints the reference CLI's tokens and, with ``--ft``, its ledger (2
    entries x 6 layers), with both packages' SMOKE config at float32
    activations.

    At bfloat16 this random-weight model amplifies a one-step rounding
    difference past a top-two logit gap: the reference's jitted step (XLA
    fuses bfloat16 operations and keeps some intermediates in float32) and
    its own operation-by-operation step give different tokens (row 0,
    the 13th), and torch's and XLA's CPU bf16 products sum in different
    orders (row 2, the 8th, against the operation-by-operation run). The
    bf16 forward is held to a tolerance instead
    (``tests/test_torch_models.py``)."""
    for mod, get in ((ref_launch, ref_configs.get_smoke_config),
                     (launch, configs.get_smoke_config)):
        monkeypatch.setattr(mod, "get_smoke_config",
                            lambda arch, get=get: dataclasses.replace(
                                get(arch), dtype="float32"))
    got, want = _cli_both(["--arch", "recurrentgemma-2b", "--preset",
                           "tiny", *(["--ft"] if ft else [])], capsys,
                          monkeypatch)
    assert got == want
    assert got[0] == "generated (4, 32)"
    if ft:
        assert re.search(r"detected=12 corrected=12", got[1]), got[1]


@pytest.mark.parametrize("ft", [False, True], ids=["clean", "ft"])
@pytest.mark.parametrize("arch", ["deepseek-v3-671b",
                                  "llama4-maverick-400b-a17b"])
def test_cli_lm_mode_moe_matches_reference(arch, ft, capsys, monkeypatch):
    """``--mode lm --arch deepseek-v3-671b|llama4-maverick-400b-a17b
    --preset tiny`` (SMOKE: MLA and 8 experts top-2 with a shared expert;
    GQA and 4 experts top-1, MoE every other layer; batch 4, prompt 16,
    gen 32) prints the reference CLI's tokens and, with ``--ft``, its
    ledger (2 entries x 4 layers), both packages' SMOKE config at float32
    activations: at bfloat16 a router's near-tie can flip between the two
    packages' roundings (``tests/test_torch_models.py``)."""
    for mod, get in ((ref_launch, ref_configs.get_smoke_config),
                     (launch, configs.get_smoke_config)):
        monkeypatch.setattr(mod, "get_smoke_config",
                            lambda arch, get=get: dataclasses.replace(
                                get(arch), dtype="float32"))
    got, want = _cli_both(["--arch", arch, "--preset", "tiny",
                           *(["--ft"] if ft else [])], capsys, monkeypatch)
    assert got == want
    assert got[0] == "generated (4, 32)"
    if ft:
        assert re.search(r"detected=8 corrected=8", got[1]), got[1]


def _cli_both(argv, capsys, monkeypatch):
    """Run the reference CLI and then the port's on the reference's params
    with ``argv``: (the port's lines, the reference's)."""
    held = {}
    ref_init = RefModel.init

    def keep(self, key):
        held["params"] = ref_init(self, key)
        return held["params"]

    monkeypatch.setattr(RefModel, "init", keep)
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ref_launch.main()
    monkeypatch.setattr(
        Model, "init", lambda self, gen, device="cuda": params_from_numpy(
            jax.tree.map(np.asarray, held["params"]), device=device))
    launch.main(["--device", "cpu", *argv])
    return _cli_lines(capsys.readouterr().out), _cli_lines(out.getvalue())
