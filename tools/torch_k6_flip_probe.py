"""How often K6 through the trainable on the card parts from the same
Function on the CPU (plain versions) by a near-tie route flip, over seeds:
the inputs of tests/test_torch_cuda.py `test_trainable_tail_on_card_matches_
cpu_plain`, with da's and db_table's entries off by more than K6_ELEM_TOL *
scale held to K6_FRAC_TOL and every gradient to K6_L2_TOL relative L2
(`assert_k6_close`'s rule); with `--aware`, also with the dout entries
that test file's `k6_near_ties` finds set to 0 on both sides, the rule of
`test_trainable_tail_on_card_matches_cpu_plain`, and the largest share of
such entries.

    PYTHONPATH=<root> python3 tools/torch_k6_flip_probe.py [--tables small|training] [--seeds 64]
        [--aware]

`small`: B=2, V=301, D=12 with neighbour column 1 a copy of column 0;
`training`: B=4, V=2048 with 1298 valid rows, D=12, the same copy.  It
imports the tests/ and the morig_tpu_torch that the working directory and
sys.path find, so a parent tree unpacked from `git archive` is probed from
its own root, and two trees compare in one call on one card.
"""
from __future__ import annotations

import argparse
import sys

import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tables", choices=("small", "training"), default="small")
    ap.add_argument("--seeds", type=int, default=64)
    ap.add_argument("--aware", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_k6_flip_probe.py probes the card: no CUDA device")
    sys.path.insert(0, "tests")
    import test_torch_cuda as T
    from morig_tpu_torch.kernels import edge_fused as ef

    cuda = torch.device("cuda", 0)

    def over_tolerance(args, dout) -> tuple[bool, float]:
        a, b, nbr, mask, *params = args
        grads = []
        for dev in (cuda, torch.device("cpu")):
            leaves = [t.detach().float().to(dev).requires_grad_() for t in (a, b, *params)]
            out = ef.fused_edge_mlp_trainable(leaves[0], leaves[1], nbr.to(dev), mask.to(dev),
                                              *leaves[2:])
            (out * dout.to(dev)).sum().backward()
            grads.append([t.grad.cpu() for t in leaves])
        worst, rel = 0.0, 0.0
        for name, x, y in zip(T.K6_NAMES, *grads):
            rel = max(rel, ((x - y).norm() / y.norm().clamp(min=1e-30)).item())
            if name in ("da", "db_table"):
                err = (x - y).abs()
                scale = max(y.abs().max().item(), 1.0)
                worst = max(worst, (err > T.K6_ELEM_TOL * scale).float().mean().item())
        return worst > T.K6_FRAC_TOL or rel > T.K6_L2_TOL, worst

    for H in (128, 256):
        over, fracs, over_aware, near_share = [], [], [], []
        for seed in range(args.seeds):
            if args.tables == "small":
                targs, dout = T._bwd_args(cuda, H, seed=seed)
            else:
                targs, dout = T._training_tables(cuda, H, 12, seed=seed)
                nbr, mask = targs[2], targs[3]
                nbr[:, :, 1], mask[:, :, 1] = nbr[:, :, 0], mask[:, :, 0]
            bad, worst = over_tolerance(targs, dout)
            fracs.append(worst)
            if bad:
                over.append(seed)
            if args.aware:
                near = T.k6_near_ties(targs)
                near_share.append(near.sum().item() / (targs[3].any(-1).sum().item() * H))
                if over_tolerance(targs, dout * (~near).to(cuda))[0]:
                    over_aware.append(seed)
        print(f"K6 flip probe, {args.tables} tables, H={H}: {len(over)} of {args.seeds} seeds over "
              f"K6_FRAC_TOL or K6_L2_TOL {over}; largest fraction {max(fracs):.3g}")
        if args.aware:
            print(f"  with the near-tie dout entries at 0: {len(over_aware)} of {args.seeds} seeds "
                  f"over {over_aware}; near-tie share of the dout entries at most "
                  f"{max(near_share):.3g}")


if __name__ == "__main__":
    main()
