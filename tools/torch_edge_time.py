"""The edge kernels' phase-3 checks and times of chip_smoke.py on one NVIDIA
GPU, without the rest of the smoke run: K1 at the serving path's five widths
(and on random full tables), K5, K6 at the training tables and, where the
tree has them, KN and KNB, the narrow layers' fp32 tail, each against its
plain version with its device, call, plain and bound ms.

    PYTHONPATH=<root> python3 tools/torch_edge_time.py

It imports the chip_smoke.py and the morig_tpu_torch that sys.path finds,
so a parent tree unpacked from `git archive` is timed with PYTHONPATH
pointing at it, and two trees compare in one call on one card.
"""
from __future__ import annotations

import time

import torch


def main() -> None:
    import chip_smoke as cs
    from morig_tpu_torch.core.batch import stack_meshes
    from morig_tpu_torch.data.synthetic import capsule_batch
    from morig_tpu_torch.kernels import build as kb

    if not torch.cuda.is_available():
        raise SystemExit("torch_edge_time.py times the card: no CUDA device")
    dev = torch.device("cuda", 0)
    print(f"device: {cs.gpu_name_power()}; torch {torch.__version__}; {cs.__file__}")
    kb.library()
    t0 = time.perf_counter()
    entries, _ = capsule_batch(cs.B_MESH, cs.T, cs.P, cs.V_PAD, cs.DEGREE)
    mesh_bt = stack_meshes([e for e in entries for _ in range(cs.T)])
    batch, _ = cs.train_batch()
    rows = {"K1": cs.check_k1(dev, mesh_bt), "K5": cs.check_k5(dev, mesh_bt, stack_meshes(entries)),
            "K6": cs.check_k6(dev, batch.mesh)}
    if hasattr(cs, "check_kn"):
        rows["KN"], rows["KNB"] = cs.check_kn(dev, batch.mesh)
    for name, res in rows.items():
        print(f"{name}: device {res.device_ms:.4f} ms, call {res.call_ms:.4f} ms, plain "
              f"{res.plain_ms:.4f} ms, bound {res.bound_ms:.4f} ms ({res.bound_by})")
    print(f"edge kernels: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
