"""``python -m repro_torch.launch.train pinn`` (the reference's
``launch/train.py`` entry point) on the CPU: single-process and
``--distributed`` runs (4 ``gloo`` ranks, a temporary ``FileStore``) of
the same problem reach the same loss (1e-4 relative), a distributed
checkpoint resumes in the single-process trainer and continues the
uninterrupted trajectory (1e-4), the inverse problem (``heat2d_inverse``
on the US map, two nets) runs, ``lm`` trains a reduced family and
prints its JSON line (the LM path's parity is
``tests/test_torch_lm_train.py``) while a family with no registered
block raises ``NotImplementedError``, and without ``--device`` the entry
point refuses to run where there is no card.

Small sizes: 2 x 2 Burgers, 16 x 2 nets, 64 residual points per
subdomain, the reference's default residual path (jvp)."""
import dataclasses
import json

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.models import causal_lm

SMALL = ["--nx", "2", "--nt", "2", "--width", "16", "--depth", "2",
         "--n-res", "64", "--n-bnd", "16", "--n-iface", "8",
         "--log-every", "10", "--lr", "2e-3"]
RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(capsys, *argv) -> dict:
    assert train.main(["pinn", "--device", "cpu", *argv]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])["train"], out


def test_single_process_run_reports_loss_and_rel_l2(capsys):
    out, lines = _run(capsys, *SMALL, "--steps", "20")
    assert out["trainer"] == "ReferenceTrainer" and out["steps"] == 20
    assert out["loss"] > 0 and 0 < out["rel_l2"] < 2
    assert any("step 20/20" in line for line in lines)


def test_distributed_run_matches_single_process(capsys):
    single, _ = _run(capsys, *SMALL, "--steps", "20")
    dist, lines = _run(capsys, *SMALL, "--steps", "20", "--distributed")
    assert dist["trainer"] == "DistributedDDTrainer"
    assert any("backend gloo, 4 ranks" in line for line in lines)
    assert dist["loss"] == pytest.approx(single["loss"], rel=RTOL)
    assert dist["rel_l2"] == pytest.approx(single["rel_l2"], rel=RTOL)
    assert dist["staged_bytes"] == 0          # CPU tensors go as they are


def test_distributed_checkpoint_resumes_single_process(capsys, tmp_path):
    ck = str(tmp_path / "ck")
    _run(capsys, *SMALL, "--steps", "20", "--distributed", "--ckpt-dir", ck,
         "--ckpt-every", "10")
    resumed, lines = _run(capsys, *SMALL, "--steps", "30", "--ckpt-dir", ck,
                          "--resume")
    whole, _ = _run(capsys, *SMALL, "--steps", "30")
    assert resumed["start"] == 20 and any("resumed from step 20" in line
                                          for line in lines)
    assert resumed["loss"] == pytest.approx(whole["loss"], rel=RTOL)


def test_inverse_heat_problem_on_the_us_map(capsys):
    out, _ = _run(capsys, "--pde", "heat2d_inverse", "--steps", "2",
                  "--width", "8", "--depth", "2", "--n-res", "16",
                  "--n-bnd", "8", "--n-iface", "4", "--n-data", "8",
                  "--log-every", "1")
    assert out["trainer"] == "ReferenceTrainer" and out["loss"] > 0
    assert out["steps"] == 2 and out["rel_l2"] > 0   # against its exact u


def test_lm_is_not_ported_yet(monkeypatch):
    """``lm`` on a family with no registered block (a config whose family
    is absent from ``BLOCKS``) raises, naming ROADMAP."""
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              family="unported")
    assert cfg.family not in causal_lm.BLOCKS
    monkeypatch.setattr(train, "lm_config", lambda args: cfg)
    with pytest.raises(NotImplementedError, match="not ported yet.*ROADMAP"):
        train.main(["lm", "--reduced", "--device", "cpu", "--steps", "1"])


@pytest.mark.parametrize("arch", ["llama3.2-1b", "minicpm3-4b", "rwkv6-3b",
                                  "deepseek-moe-16b",
                                  "seamless-m4t-large-v2"])
def test_lm_runs_and_prints_its_json_line(capsys, arch):
    assert train.main(["lm", "--arch", arch, "--reduced", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "32",
                       "--log-every", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])["train_lm"]
    assert out["arch"] == arch and out["device"] == "cpu"
    assert out["steps"] == 2 and len(out["losses"]) == 2
    assert out["final_loss"] == out["losses"][-1] > 0
    assert out["tokens_per_s"] > 0
    assert any("step 2/2" in line for line in lines)


def test_needs_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["pinn", *SMALL, "--steps", "1"])


def test_lm_needs_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["lm", "--reduced", "--steps", "1"])
