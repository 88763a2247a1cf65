"""Small configurations of the benchmark's models for CPU tests: the
configuration file's ``model`` with its widths cut, its kind of layers
kept."""
from __future__ import annotations

from portbench import run

SMALL = {
    "moe": dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                head_dim=16, d_ff=32, vocab=256, n_experts=8, top_k=2,
                d_expert=32, n_shared_experts=1, d_ff_dense=96),
    "mla": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                vocab=250, q_lora=32, kv_lora=16, nope_dim=8, rope_dim=8,
                v_head_dim=16),
}


def small_model(config: str, **over) -> dict:
    m = dict(run.load_json("configs", config)["model"])
    m.update(SMALL[m["family"]], **over)
    return m


def reduced_model(config: str, **over) -> dict:
    """The configuration at the port's own ``ModelConfig.reduced()``
    sizes (its CPU smoke size)."""
    import dataclasses

    from portbench import program

    m = dataclasses.asdict(program.model_config(
        run.load_json("configs", config)["model"]).reduced())
    m.update(over)
    return m


def small_cell(name: str, **params) -> dict:
    cell = run.load_json("workloads", name)
    cell["params"] = dict(cell["params"], **params)
    return cell
