"""``python -m repro_torch.launch.train`` on the recurrent and MoE
architectures at ``--preset tiny --device cpu``, every linear protected:
each trains and prints the reference CLI's step lines, nothing flagged;
DeepSeek-V3's logged losses (the aux term included) are the reference
CLI's from the same params at float32 activations (its params handed
across, as ``tests/test_torch_encdec.py`` does), within 1e-5 relative.
"""
from __future__ import annotations

import math
import sys

import numpy as np
import pytest

from repro import configs as ref_configs
from repro.launch import train as ref_launch_train

from repro_torch import configs
from repro_torch.launch import train as launch_train

from test_torch_encdec import _float32_smoke, _hand_reference_params
from test_torch_train import _STEP_LINE

ARGV = ["--preset", "tiny", "--steps", "2", "--batch", "2", "--seq", "16",
        "--log-every", "1", "--ft-linears"]


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-350m",
                                  "deepseek-v3-671b",
                                  "llama4-maverick-400b-a17b"])
def test_cli_trains_recurrent_and_moe(arch, capsys):
    log = launch_train.main(["--device", "cpu", "--arch", arch, *ARGV])
    lines = _STEP_LINE.findall(capsys.readouterr().out)
    assert [int(m[0]) for m in lines] == [m["step"] for m in log] == [0, 1]
    assert all(math.isfinite(m["loss"]) and m["ft_flagged"] == 0
               and m["skipped_updates"] == 0 for m in log)
    assert all(int(m[4]) == 0 for m in lines)
    moe = "deepseek" in arch or "llama4" in arch
    assert all((m["moe_aux"] > 0) == moe for m in log)


def test_cli_deepseek_matches_reference(monkeypatch):
    _float32_smoke(monkeypatch,
                   (ref_launch_train, ref_configs.get_smoke_config),
                   (launch_train, configs.get_smoke_config))
    hand = _hand_reference_params(monkeypatch)
    argv = ["--arch", "deepseek-v3-671b", *ARGV]
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    want = ref_launch_train.main()
    hand()
    got = launch_train.main(["--device", "cpu", *argv])
    assert [m["step"] for m in got] == [m["step"] for m in want] == [0, 1]
    for g, w in zip(got, want):
        for k in ("loss", "ce", "grad_norm", "moe_aux"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5)
        assert g["ft_flagged"] == w["ft_flagged"] == 0
