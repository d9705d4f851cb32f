"""The port's serving CLI (``python -m repro_torch.launch.serve``) and its
``serve_fft`` endpoint against the reference ``repro.launch.serve`` on
the CPU (``--device cpu``: the kernels' plain versions).

``--mode fft`` prints the same telemetry dict as the reference for the
same worker description, and both print a ``rel_err`` against numpy under
the suite's complex64 tolerance (4e-5). ``--mode serve`` serves its mixed
self-test workload with every request completed and the same bucket
ledger as the reference. The mesh flags on one process plan locally, as
the reference's one-device mesh does (``tests/test_torch_serve_mesh.py``
runs them on four ranks); ``--mode lm`` serves Whisper.
"""
from __future__ import annotations

import argparse
import ast
import json
import re
import sys

import numpy as np
import pytest
import torch

from repro.core.fft import api as ref_api
from repro.launch import serve as ref_launch

from repro_torch.core.fft import api
from repro_torch.launch import serve as launch
from repro_torch.serve import apply_fft_spec_arg

TOL = 4e-5          # ATOL[complex64]: rel_err is max|y - ref| / max|ref|


@pytest.fixture(autouse=True)
def _fresh_cache():
    api.plan_cache_clear()
    ref_api.plan_cache_clear()
    yield
    api.plan_cache_clear()
    ref_api.plan_cache_clear()


def _run_port(capsys, *argv) -> str:
    launch.main(["--device", "cpu", *argv])
    return capsys.readouterr().out


def _run_reference(capsys, monkeypatch, *argv) -> str:
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    ref_launch.main()
    return capsys.readouterr().out


def _buckets(out: str) -> dict:
    """The per-bucket telemetry JSON block ``--mode serve`` prints."""
    lines = out.splitlines()
    start = lines.index("{")
    return json.loads("\n".join(lines[start:lines.index("}", start) + 1]))


def _fft_line(out: str):
    """(info dict, rel_err) of ``--mode fft``'s result line."""
    line = out.strip().splitlines()[-1]
    info = ast.literal_eval(re.search(r"(\{.*\})", line)[1])
    return info, float(re.search(r"rel_err=(\S+)", line)[1])


FFT_MODES = [
    ("fft", "n=256,batch=4"),
    ("ft", "n=256,batch=4,ft=1"),
    ("real", "n=256,batch=4,real=1"),
    ("spectrum", "n=256,batch=4,op=spectrum"),
    ("convolve", "n=200,batch=4,op=convolve,kernel_n=31"),
    ("correlate", "n=200,batch=4,op=correlate,kernel_n=31"),
    ("grid", "dims=2,rows=16,cols=32,batch=2"),
]


@pytest.mark.parametrize("spec", [s for _, s in FFT_MODES],
                         ids=[k for k, _ in FFT_MODES])
def test_cli_fft_mode_matches_reference(spec, capsys, monkeypatch):
    argv = ("--mode", "fft", "--fft-iters", "1", "--fft-spec", spec)
    info, err = _fft_line(_run_port(capsys, *argv))
    ref_info, ref_err = _fft_line(_run_reference(capsys, monkeypatch,
                                                 *argv))
    if "score" in info:
        assert info.pop("score") < 1e-4 and ref_info.pop("score") < 1e-4
    assert info == ref_info
    assert err < TOL and ref_err < TOL


def test_cli_serve_mode_serves_the_self_test(capsys, monkeypatch):
    spec = "n=256,workers=2,max_batch=4,deadline_ms=2"
    argv = ("--mode", "serve", "--serve-requests", "24", "--fft-spec", spec)
    out = _run_port(capsys, *argv)
    err = float(re.search(r"rel_err=(\S+)", out)[1])
    assert err < TOL, out
    buckets = _buckets(out)
    ref_buckets = _buckets(_run_reference(capsys, monkeypatch, *argv))
    assert set(buckets) == set(ref_buckets) == {
        "fft:256:c64", "fft:256:c64:ft", "fft:256:c64:real",
        "spectrum:256:c64"}
    for label, st in buckets.items():
        ref = ref_buckets[label]
        assert st["submitted"] == st["completed"] == 6, (label, st)
        assert (ref["submitted"], ref["completed"]) == (6, 6), (label, ref)
        assert st["failed"] == st["rejected"] == st["timeouts"] == 0


def test_cli_serve_mode_default_n_refuses_the_ft_tenant(capsys):
    """At the default ``--fft-n 65536`` the self-test's ft tenant needs a
    multi-pass fused ABFT, which the kernel does not run (N <= 8192): the
    port raises, as the reference does."""
    with pytest.raises(ValueError, match="single-pass"):
        _run_port(capsys, "--mode", "serve", "--serve-requests", "4")


def test_cli_lm_mode_serves_whisper(capsys):
    """``--mode lm`` serves every architecture of the reference, the
    encoder-decoder Whisper too (``tests/test_torch_encdec.py`` holds its
    tokens and ledger against the reference CLI's)."""
    out = _run_port(capsys, "--mode", "lm", "--arch", "whisper-base",
                    "--preset", "tiny", "--batch", "2", "--prompt-len", "4",
                    "--gen", "4")
    assert out.startswith("generated (2, 4) in "), out


@pytest.mark.parametrize("flags", [("--fft-shards", "2"), ("--fft-data", "2"),
                                   ("--fft-chunks", "2"),
                                   ("--fft-chunks", "auto"),
                                   ("--fft-spec", "n=64,shards=4")],
                         ids=["shards", "data", "chunks", "chunks-auto",
                              "spec-shards"])
@pytest.mark.parametrize("mode", ["fft", "serve"])
def test_cli_mesh_flags_name_item_10(mode, flags, capsys, monkeypatch):
    """The mesh flags on one process: the port plans locally (no process
    group runs), as the reference plans on its one-device mesh; ``--mode
    fft`` prints the reference's telemetry, ``--mode serve`` completes the
    reference's buckets (``tests/test_torch_serve_mesh.py`` runs them on
    four ranks)."""
    argv = ("--mode", mode, "--fft-n", "64", "--fft-iters", "1",
            "--serve-requests", "16", *flags)
    out = _run_port(capsys, *argv)
    ref = _run_reference(capsys, monkeypatch, *argv)
    if mode == "fft":
        (info, err), (ref_info, ref_err) = _fft_line(out), _fft_line(ref)
        assert info == ref_info == {"shards": 1, "data": 1, "op": "fft",
                                    "ft": False}
        assert err < TOL and ref_err < TOL
        return
    assert float(re.search(r"rel_err=(\S+)", out)[1]) < TOL, out
    buckets, ref_buckets = _buckets(out), _buckets(ref)
    assert set(buckets) == set(ref_buckets) == {
        "fft:64:c64", "fft:64:c64:ft", "fft:64:c64:real",
        "spectrum:64:c64"}
    for label, st in buckets.items():
        assert st["submitted"] == st["completed"] \
            == ref_buckets[label]["completed"] == 4, (label, st)


def test_serve_fft_matches_reference(rng, assert_spectrum_close):
    x = (rng.standard_normal((4, 128)) +
         1j * rng.standard_normal((4, 128))).astype(np.complex64)
    got, info = launch.serve_fft(torch.from_numpy(x), ft=True, device="cpu")
    want, ref_info = ref_launch.serve_fft(x, ft=True)
    assert got.device.type == "cpu"
    assert info.pop("score") < 1e-4 and ref_info.pop("score") < 1e-4
    assert info == ref_info
    assert_spectrum_close(got.numpy(), np.asarray(want))
    # two shards asked on one process: the one-device plan, as the
    # reference's on its one-device mesh
    got, info = launch.serve_fft(x, shards=2, device="cpu")
    want, ref_info = ref_launch.serve_fft(x, shards=2)
    assert info == ref_info and info["shards"] == 1
    assert_spectrum_close(got.numpy(), np.asarray(want))


def test_serve_fft_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.serve_fft(np.zeros((2, 64), np.complex64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--mode", "fft", "--fft-n", "64"])


# -- the consolidated spec string: serving-policy keys ----------------------

def _fresh_args():
    return argparse.Namespace(
        fft_n=1 << 16, batch=4, fft_shards=None, fft_data=1, fft_dims=1,
        fft_rows=256, fft_cols=256, fft_op="fft", fft_decomp="auto",
        ft=False, fft_groups=None, fft_kernel_n=63, transposed=False,
        fft_threshold=1e-4, fft_real=False, fft_chunks=1,
        serve_workers=2, serve_max_batch=8, serve_deadline_ms=2.0,
        serve_queue_depth=64, serve_timeout_ms=None)


def test_spec_arg_serve_keys_roundtrip():
    spec = ("n=4096,workers=4,max_batch=16,deadline_ms=1.5,queue=128,"
            "timeout_ms=250,chunks=auto,real=1")
    ns = apply_fft_spec_arg(_fresh_args(), spec)
    assert ns.fft_n == 4096
    assert ns.serve_workers == 4
    assert ns.serve_max_batch == 16
    assert ns.serve_deadline_ms == 1.5
    assert ns.serve_queue_depth == 128
    assert ns.serve_timeout_ms == 250.0
    assert ns.batch == 4 and ns.ft is False
    assert vars(ns) == vars(ref_launch.apply_fft_spec_arg(_fresh_args(),
                                                          spec))


def test_spec_arg_serve_keys_strictness():
    with pytest.raises(ValueError, match="duplicate key"):
        apply_fft_spec_arg(_fresh_args(), "workers=2,workers=4")
    with pytest.raises(ValueError, match="empty segment"):
        apply_fft_spec_arg(_fresh_args(), "workers=2,,queue=8")
    with pytest.raises(SystemExit, match="unknown key"):
        apply_fft_spec_arg(_fresh_args(), "max_batchez=8")
