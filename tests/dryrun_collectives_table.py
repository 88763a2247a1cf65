"""Print the partitioned dry run's collective bytes a device beside the
reference's, for a reduced config of each of the seven families at the
production shapes on a (2, 4) mesh, as a markdown table.

The reference's records come from ``tests/test_torch_dryrun.py``'s
subprocesses (its ``lower_cell`` on 8 fake CPU devices, no unrolled fit);
the port's from ``lower_cell(..., partitioned=True)`` in this process.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/dryrun_collectives_table.py
"""
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import test_torch_dryrun as T  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402


def _reference() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(T.REPO, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"OPTIONS = {{}}\n"
         + T.REF_CODE.format(archs=archs, shapes=T.SLICE_SHAPES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for archs in (T.SLICE_ARCHS[:2], T.SLICE_ARCHS[2:5],
                      T.SLICE_ARCHS[5:])]
    out = {}
    for proc in procs:
        stdout, err = proc.communicate(timeout=900)
        if proc.returncode:
            raise SystemExit(err[-3000:])
        for line in stdout.splitlines():
            if line.startswith("REC "):
                r = json.loads(line[4:])
                out[(r["arch"], r["shape"])] = r["collectives"]
    return out


def _counts(c) -> str:
    return ", ".join(f"{k} {v}" for k, v in sorted(c["counts"].items()))


def main() -> int:
    ref = _reference()
    print("| Cell | Reference bytes | Port bytes | Port / ref | Reference "
          "counts | Port counts |")
    print("|---|---|---|---|---|---|")
    for arch in T.SLICE_ARCHS:
        for shape in T.SLICE_SHAPES:
            _, rec = dryrun.lower_cell(arch, shape,
                                       cfg_override=ARCHS[arch].reduced(),
                                       mesh=T.MESH, partitioned=True)
            want, got = ref[(arch, shape)], rec["collectives"]
            ratio = got["total_bytes"] / want["total_bytes"] \
                if want["total_bytes"] else float("nan")
            print(f"| {arch} {shape} | {int(want['total_bytes']):,} | "
                  f"{int(got['total_bytes']):,} | {ratio:.3f} | "
                  f"{_counts(want)} | {_counts(got)} |", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
