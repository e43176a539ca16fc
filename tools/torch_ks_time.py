"""Device time of the ordered row scatter KS of morig_tpu_torch
(`kernels.gather_fused`) on one NVIDIA GPU, at chip_smoke.py's phase-3
shapes: K2's backward (the vismask 1-NN: B=4, 2048 queries, k=1, into 1024
points, 64 fp32 wide, through `scatter_rows`) and K6's db_table over the
training tables (4 capsules, V=1298 padded to 2048, degree 12, the valid
edges' bf16 rows at H = 16, 32, 128, 256, over the batch's `tpl_rev`).

    PYTHONPATH=<root> python3 tools/torch_ks_time.py

It times the morig_tpu_torch that sys.path finds, so a parent tree
unpacked from `git archive` is timed with PYTHONPATH pointing at it, and
makes phase 3's inputs itself (the same seeds).  Per shape, each under
torch.profiler over REPS calls, / REPS (`torch_kg_time.device_ms`): the
device ms of the kernel (`row_scatter_kernel`), at K6's shapes also of the
same sum under K6's name (`edge_db_sum_kernel`), of one `torch.index_add`
on the same rows (the library call), and of the reverse table's build
(`reverse_table`, every op: at K2's shape a call's own table, at K6's the
batch's), on trees that can choose the sort's key width with 32-bit and
64-bit keys; the bound (chip_smoke.py `check_scatter`'s bytes at 3.35
TB/s) and the plan on trees that have `plan_scatter`.  Then the sums over
the five shapes.  Prints the card's name and power limit.
"""
from __future__ import annotations

import inspect
import subprocess

import torch

from torch_kg_time import device_ms

HBM_BYTES_PER_S = 3.35e12
P, TRAIN_B, WIDTHS = 1024, 4, (16, 32, 128, 256)


def training_mesh(dev):
    """chip_smoke.py `train_batch`'s mesh: 4 capsules (n_lat=37, n_lon=36,
    V=1298 in the 2048 bucket, degree-12 tables) at frame pair (0, 2)."""
    from morig_tpu_torch.data.pose import PoseDataset, capsule_pose_dataset

    ds = capsule_pose_dataset(num_models=TRAIN_B, num_frames=4, num_points=P, n_lat=37,
                              n_lon=36)
    ds = PoseDataset(ds.models, tpl_max_degree=12, geo_max_degree=12)
    return ds.batch(list(range(TRAIN_B)), 0, 2, device=dev).mesh


def cases(dev, mesh):
    """chip_smoke.py `check_scatter`'s five shapes, from its generator:
    (name, idx, rows, n, mask)."""
    g = torch.Generator(device=dev).manual_seed(8)
    idx = torch.randint(0, P, (TRAIN_B, 2048, 1), device=dev, generator=g)
    rows = torch.randn(TRAIN_B, 2048, 1, 64, device=dev, generator=g)
    out = [("K2 backward (vismask 1-NN)", idx, rows, P, None)]
    Bn, V, D = mesh.tpl_nbr.shape
    for H in WIDTHS:
        rows = torch.randn(Bn, V, D, H, device=dev, generator=g).to(torch.bfloat16)
        out.append((f"K6 db_table H={H}", mesh.tpl_nbr, rows, V, mesh.tpl_mask))
    return out


def main() -> None:
    from morig_tpu_torch.kernels import build as kb
    from morig_tpu_torch.kernels import gather_fused as gf

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"device: {card}; torch {torch.__version__}; package {gf.__file__}")
    kb.library()
    widths = ((False, True) if "wide" in inspect.signature(gf.reverse_table).parameters
              else (None,))
    mesh = training_mesh(dev)
    tot = dict(ks=0.0, db=0.0, lib=0.0, bound=0.0)
    tot.update({f"table{w}": 0.0 for w in widths})
    for name, idx, rows, n, mask in cases(dev, mesh):
        B, C = idx.shape[0], rows.shape[-1]
        flat = rows.reshape(-1, C)
        if mask is None:
            fn = lambda: gf.scatter_rows(idx, rows, n)              # noqa: E731
            db = None
            src = rows
        else:
            order, offsets = mesh.tpl_rev
            fn = lambda: gf.row_scatter_launch(flat, order, offsets, B * n)   # noqa: E731
            db = device_ms(lambda: gf.row_scatter_launch(flat, order, offsets, B * n,
                                                         edge_db=True), "edge_db_sum_kernel")
            src = rows * mask[..., None]
        got = fn()
        again = fn()
        ref = gf.scatter_rows_plain(idx.cpu(), src.cpu(), n).reshape(B * n, C)
        same = torch.equal(got.reshape(B * n, C).cpu(), ref) and torch.equal(got, again)
        keys = (idx.reshape(B, -1) + n * torch.arange(B, device=dev)[:, None]).reshape(-1)
        src32 = src.reshape(-1, C).float()
        zeros = torch.zeros(B * n, C, device=dev)
        t_k = device_ms(fn, "row_scatter_kernel")
        t_l = device_ms(lambda: torch.index_add(zeros, 0, keys, src32))
        tables = {}
        for w in widths:
            kw = {} if w is None else {"wide": w}
            tables[w] = device_ms(lambda: gf.reverse_table(idx, n, mask, **kw))
        n_src = idx.numel() if mask is None else int(mask.sum())
        n_bytes = n_src * (C * rows.element_size() + 8) + 8 * (B * n + 1) + 4 * B * n * C
        bound = n_bytes / HBM_BYTES_PER_S * 1e3
        plan = ""
        if hasattr(gf, "plan_scatter"):
            p = gf.plan_scatter(B * n, C, rows.element_size(), flat.data_ptr() % 16 == 0,
                                torch.cuda.get_device_properties(dev).multi_processor_count)
            plan = (f"; plan {p.route} route, group {p.group} of "
                    f"{getattr(p, 'rows_per_group', 1)} row(s), block {p.threads}, grid {p.grid}")
        table = ", ".join(f"{'default' if w is None else ('64' if w else '32') + '-bit keys'} "
                          f"{t:.4f}" for w, t in tables.items())
        print(f"KS {name}: rows {tuple(rows.shape)} {rows.dtype}, {n_src} sources: device "
              f"{t_k:.4f} ms ({bound / t_k:.1%} of its {bound:.4f} ms bound)"
              + (f", as edge_db_sum_kernel {db:.4f} ms" if db is not None else "")
              + f"; index_add {t_l:.4f} ms; reverse table build {table} ms; equal to the "
              f"CPU's index_add_ and to itself bit for bit: {same}{plan}")
        tot["ks"] += t_k
        tot["db"] += db or 0.0
        tot["lib"] += t_l
        tot["bound"] += bound
        for w, t in tables.items():
            tot[f"table{w}"] += t
    print(f"KS over the 5 phase-3 shapes: device {tot['ks']:.4f} ms, bound {tot['bound']:.4f} "
          f"ms ({tot['bound'] / tot['ks']:.1%}), K6's four as edge_db_sum_kernel "
          f"{tot['db']:.4f} ms, index_add {tot['lib']:.4f} ms, reverse table builds "
          + ", ".join(f"{k[5:]} {v:.4f}" for k, v in tot.items() if k.startswith("table"))
          + f" ms; {card}")


if __name__ == "__main__":
    main()
