"""The PyTorch port's training path end to end on the CPU: the port of
``tests/test_e2e.py``'s Burgers XPINN convergence run."""
import numpy as np

from repro_torch.core import (XPINN, Burgers1D, CartesianDecomposition,
                              DDConfig, ReferenceTrainer, build_topology,
                              evaluate_l2)
from repro_torch.core.nets import MLPConfig, SubdomainModelConfig
from repro_torch.data import make_batch
from test_torch_train_kernels import one_torch_thread  # noqa: F401


def test_burgers_xpinn_converges_toward_exact():
    """The port of tests/test_e2e.py's Burgers XPINN run, on the port's
    main (fused) path through the kernels' plain versions: 900 steps at
    n_res 512; rel-L2 against Cole-Hopf ends below 0.45 and below half its
    initial value."""
    pde = Burgers1D()
    dec = CartesianDecomposition(((-1, 1), (0, 1)), 2, 2)
    topo = build_topology(dec, 20)
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 24, 4)})
    batch = make_batch(dec, topo, pde, 512, 64, np.random.default_rng(0))
    tr = ReferenceTrainer(pde, cfg, topo,
                          DDConfig(method=XPINN, residual_path="fused"),
                          lrs=2e-3, device="cpu")
    st = tr.init(0)
    b = batch.device_arrays()
    l2 = lambda s: evaluate_l2(dec, cfg, s.params, tr.act_codes, pde,
                               device="cpu")
    e0 = l2(st)
    st, _ = tr.run_chunk(st, b, 900)
    e1 = l2(st)
    assert e1 < 0.45 and e1 < 0.5 * e0, (e0, e1)


def test_quickstart_main_checkpoints_and_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.quickstart`` on the CPU: trains to the
    reference's bar, checkpoints with --save-every, and --resume continues
    from the saved step."""
    import json

    from repro_torch.launch import quickstart

    ck = str(tmp_path / "ck")
    assert quickstart.main(["--device", "cpu", "--steps", "300", "--chunk",
                            "150", "--save-every", "150", "--ckpt", ck]) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["quickstart"]["steps"] == 300
    assert [r["step"] for r in first["quickstart"]["chunks"]] == [150, 300]
    assert first["quickstart"]["rel_l2"] < 0.5
    assert quickstart.main(["--device", "cpu", "--steps", "320", "--chunk",
                            "20", "--resume", ck]) == 0
    out = capsys.readouterr().out
    assert "resumed from" in out and "at step 300" in out
    last = json.loads(out.strip().splitlines()[-1])["quickstart"]
    assert [r["step"] for r in last["chunks"]] == [320]
