"""The port's joint-threshold sweep (tools/torch_sweep_joint_params.py)
against the JAX tool (tools/sweep_joint_params.py) on the CPU:

  * the sweep phase on the committed campaign_v3/joint_sweep_inputs.npz
    reproduces campaign_v3/joint_sweep_result.json, which the JAX sweep
    wrote from that file: the same best, the same joint count per held-out
    creature, every metric within SWEEP_TOL;
  * on a cut grid and cut seed lists, the port's sweep and the JAX
    `sweep()` run in the same test give the same validation results for
    every configuration, hence the same ranking, and the same held-out
    results;
  * the dump phase against the JAX `dump()` with the weights carried across
    (JAX `save_checkpoint` -> the port's `load_flax_checkpoint` -> `.pt`)
    on small creatures: the GT joints exact, the shifted points and
    attention at NETWORK, the inside masks the JAX voxelization and
    containment of the port's points exactly and the JAX dump's exactly
    wherever both sides' points share a voxel cell;
  * the three new scripts take their JAX counterparts' flags and defaults
    (--device in place of --platform), import and print their help with jax
    and the JAX package blocked, and without a card their default device
    is an error.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from morig_tpu.data import creature as jcreature
from morig_tpu.geometry import voxel as jvoxel

import torch_port_fixtures as F
from torch_port_fixtures import NETWORK, assert_rel_close

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V3 = os.path.join(ROOT, "campaign_v3")
BLOCKED = ("jax", "flax", "optax", "msgpack", "morig_tpu")
SCRIPTS = ("tools/torch_sweep_joint_params.py", "tools/torch_diagnose_joints.py",
           "examples/torch_capsule_end_to_end.py")
# Both sides cluster in fp32 with the same formulas (bisection bandwidth, the
# JAX package's "auto" top-k mode, and the mean-shift's matmul expansion);
# summation order moves the last bits only.  Measured on the v3 inputs:
# 3.7e-9 on the metrics.
SWEEP_TOL = 1e-4
METRICS = ("joint_IoU", "joint_precision", "joint_recall", "chamfer_j2j")


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ts = _load("tools/torch_sweep_joint_params.py", "torch_sweep_joint_params")
js = _load("tools/sweep_joint_params.py", "sweep_joint_params")


def _linked(tmp, name="joint_sweep_inputs.npz", src=V3) -> str:
    """A directory whose inputs file is the committed one, read in place."""
    os.makedirs(tmp, exist_ok=True)
    os.symlink(os.path.join(src, name), os.path.join(tmp, name))
    return str(tmp)


def _assert_metrics_close(got: dict, ref: dict, what: str):
    assert got["n_pred"] == ref["n_pred"], (what, got["n_pred"], ref["n_pred"])
    for k in METRICS:
        if np.isinf(ref[k]):
            assert np.isinf(got[k]), (what, k)
        else:
            assert abs(got[k] - ref[k]) <= SWEEP_TOL, (what, k, got[k], ref[k])


@pytest.fixture
def topk_auto():
    """The JAX bandwidth in its "auto" (bisection) mode, the port's only one."""
    from morig_tpu.kernels import neighbors as jnb

    old = jnb.get_topk_mode()
    jnb.set_topk_mode("auto")
    yield
    jnb.set_topk_mode(old)


# ---------------------------------------------------------------------------
# the sweep phase
# ---------------------------------------------------------------------------

def test_sweep_reproduces_campaign_v3(tmp_path):
    """The default grid on campaign_v3's dumped inputs (read in place): the
    result JSON's best is v3's (its four JAX keys, plus
    bandwidth_sample_rows 0 and the device), every held-out creature's
    joint count equal and its metrics within SWEEP_TOL, the aggregate too."""
    d = _linked(tmp_path / "v3")
    out = ts.main(["--dir", d, "--device", "cpu"])
    with open(os.path.join(V3, "joint_sweep_result.json")) as f:
        ref = json.load(f)
    with open(os.path.join(d, "joint_sweep_result.json")) as f:
        got = json.load(f)
    assert got == json.loads(json.dumps(out["result"]))
    assert set(got) == set(ref) | {"device"}
    assert got["device"] == {"name": "cpu", "power_limit": None}
    assert got["best"] == dict(ref["best"], bandwidth_sample_rows=0)
    assert (got["best"]["bandwidth_quantile"], got["best"]["attn_threshold"],
            got["best"]["density_threshold"], got["best"]["attn_nms_threshold"]) \
        == (0.03, 0.1, 0.02, 1.01)
    assert [p["n_pred"] for p in got["heldout"]] == [20, 18, 18, 15, 15]
    for g, r in zip(got["heldout"], ref["heldout"], strict=True):
        assert (g["seed"], g["n_gt"]) == (r["seed"], r["n_gt"])
        _assert_metrics_close(g, r, f"creature{r['seed']}")
    for k, v in ref["heldout_agg"].items():
        assert abs(got["heldout_agg"][k] - v) <= SWEEP_TOL, k
    assert abs(got["heldout_agg"]["mean_iou"] - 0.767) < 1e-3
    assert set(out["val"]) == set(ts.itertools.product(
        (0.03, 0.04, 0.05, 0.06), (0.1, 0.2, 0.3), (0.02, 0.035, 0.05), (0.7, 0.85, 1.01)))


CUT_GRID = dict(quantiles="0.03,0.05", keeps="0.1,0.3", densities="0.02,0.05",
                attn_nms="0.7,1.01")


def test_cut_sweep_matches_jax(tmp_path, monkeypatch, topk_auto):
    """A 2 x 2 x 2 x 2 grid on one validation and one test creature of
    campaign_v3, the port's sweep against the JAX `sweep()` (each writing to
    its own directory): every configuration's per-creature validation
    joint counts equal and metrics within SWEEP_TOL, hence the same ranking
    of all 16, and the same held-out results at the defaults and at the
    best."""
    for mod in (ts, js):
        monkeypatch.setattr(mod, "VAL_SEEDS", [102])
        monkeypatch.setattr(mod, "TEST_SEEDS", [203])
    jdir, tdir = _linked(tmp_path / "jax"), _linked(tmp_path / "port")

    seen = {}

    def recording_sorted(items, key):
        items = list(items)
        seen["val"] = dict(items)
        return sorted(items, key=key)

    monkeypatch.setattr(js, "sorted", recording_sorted, raising=False)
    jout = io.StringIO()
    with contextlib.redirect_stdout(jout):
        js.sweep(argparse.Namespace(dir=jdir, **CUT_GRID))
    got = ts.main(["--dir", tdir, "--device", "cpu"]
                  + [x for k, v in CUT_GRID.items() for x in (f"--{k.replace('_', '-')}", v)])

    ref_val = seen["val"]
    assert list(got["val"]) == list(ref_val) and len(ref_val) == 16
    for cfg, ms in ref_val.items():
        for g, r in zip(got["val"][cfg], ms, strict=True):
            _assert_metrics_close(g, r, str(cfg))
    ranked_ref = sorted(ref_val, key=lambda c: (-js_agg(ref_val[c])["mean_iou"],
                                                -js_agg(ref_val[c])["min_iou"]))
    assert [cfg for cfg, _ in got["ranked"]] == ranked_ref
    with open(os.path.join(jdir, "joint_sweep_result.json")) as f:
        ref = json.load(f)
    with open(os.path.join(tdir, "joint_sweep_result.json")) as f:
        res = json.load(f)
    assert res["best"] == dict(ref["best"], bandwidth_sample_rows=0)
    for g, r in zip(res["heldout"], ref["heldout"], strict=True):
        assert g["seed"] == r["seed"]
        _assert_metrics_close(g, r, f"tuned creature{r['seed']}")
    # the held-out lines at the defaults, as the JAX tool printed them
    jlines = [ln for ln in jout.getvalue().splitlines() if ln.startswith("  creature")]
    tlines = [f"  creature{p['seed']}: J={p['n_pred']}/{p['n_gt']} "
              f"IoU={p['joint_IoU']:.3f} P={p['joint_precision']:.3f} "
              f"R={p['joint_recall']:.3f} CD={p['chamfer_j2j']:.4f}"
              for name in ("default", "tuned") for p in got["heldout"][name]]
    assert tlines == jlines


def js_agg(ms) -> dict:
    """The JAX sweep's aggregate (a closure there), restated."""
    return dict(mean_iou=float(np.mean([m["joint_IoU"] for m in ms])),
                min_iou=float(np.min([m["joint_IoU"] for m in ms])))


# ---------------------------------------------------------------------------
# the dump phase
# ---------------------------------------------------------------------------

SMALL = dict(points=128, target_verts=200)      # ~190 vertices, the 256 bucket


@pytest.fixture
def jax_cache_dir(tmp_path, monkeypatch):
    """JAX's persistent compile cache pointed into tmp_path while a JAX tool
    runs (its `setup_compile_cache` reads the variable), then put back."""
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def small_campaign_dir(root: str, val_seeds, test_seeds, seed: int = 5) -> str:
    """A campaign directory for the dump: carried jointnet/mask checkpoints
    and a pred_flows.npz of seeded noise at the creatures' vertex counts."""
    rng = np.random.default_rng(seed)
    flows = {}
    for key, seeds in (("val", val_seeds), ("te", test_seeds)):
        for i, s in enumerate(seeds):
            nv = len(jcreature.make_creature(s, target_verts=SMALL["target_verts"]).verts)
            flows[f"{key}{i}"] = (0.05 * rng.standard_normal((nv, 15))).astype(np.float32)
    os.makedirs(root, exist_ok=True)
    np.savez(os.path.join(root, "pred_flows.npz"), **flows)
    ds = jcreature.creature_rig_dataset(num_models=1, seed=val_seeds[0],
                                        num_points=SMALL["points"],
                                        target_verts=SMALL["target_verts"])
    F.carried_rig_checkpoints(root, ds.batch([0]))
    return root


def test_dump_matches_jax(tmp_path, monkeypatch, jax_cache_dir):
    """The port's --dump against the JAX `dump()` on one validation and one
    test creature at 200 target vertices and 128 points, from the same
    pred_flows.npz and the same weights (the JAX checkpoints read by the
    port's `load_flax_checkpoint` and saved as .pt): the same keys, the GT
    joints exact, the shifted points and the attention at NETWORK (the JAX
    side through its Pallas kernels), the inside masks as the module
    docstring says, differing on at most INSIDE_FLIPS of the vertices."""
    for mod in (ts, js):
        monkeypatch.setattr(mod, "VAL_SEEDS", [101])
        monkeypatch.setattr(mod, "TEST_SEEDS", [202])
    root = small_campaign_dir(str(tmp_path / "camp"), [101], [202])
    with F.jax_fused_kernels():
        js.dump(argparse.Namespace(dir=root, platform="cpu", **SMALL))
    with np.load(os.path.join(root, "joint_sweep_inputs.npz")) as z:
        ref = {k: z[k] for k in z.files}
    os.remove(os.path.join(root, "joint_sweep_inputs.npz"))
    out = ts.main(["--dir", root, "--dump", "--device", "cpu", "--points", "128",
                   "--target-verts", "200"])
    with np.load(os.path.join(root, "joint_sweep_inputs.npz")) as z:
        got = {k: z[k] for k in z.files}
    assert set(got) == set(ref) == set(out) == {
        f"{s}_{k}" for s in ("val101", "te202") for k in ("shifted", "attn", "inside", "gtpos")}
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        if k.endswith("_gtpos"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        elif not k.endswith("_inside"):
            assert_rel_close(got[k], ref[k], NETWORK, what=k)
    for split, s in (("val", 101), ("te", 202)):
        key = f"{split}{s}"
        c = jcreature.make_creature(s, target_verts=SMALL["target_verts"])
        vox = jvoxel.voxelize_mesh(c.verts, c.faces)
        inside = got[f"{key}_inside"]
        # the port's mask is the JAX voxelization and containment of its own
        # points, exactly
        np.testing.assert_array_equal(inside, jvoxel.inside_check_np(got[f"{key}_shifted"], vox))
        # and the JAX dump's exactly wherever both sides' points share a cell
        same = (_cells(got[f"{key}_shifted"], vox) == _cells(ref[f"{key}_shifted"], vox)).all(1)
        np.testing.assert_array_equal(inside[same], ref[f"{key}_inside"][same], err_msg=key)
        flips = inside != ref[f"{key}_inside"]
        assert flips.mean() <= INSIDE_FLIPS, (key, int(flips.sum()))
        assert inside.any(), key


# Shifted points behind the network agree at NETWORK (bf16 products on both
# sides, summed in another order), so a point near a voxel face can round
# into the next cell (about 0.01 wide) on one side: measured at these
# weights, 24 of 146 and 20 of 168 points change cell, and 0 and 1 of them
# change between inside and outside (a 3.4e-3 difference of a shift).
INSIDE_FLIPS = 0.02


def _cells(pts, vox) -> np.ndarray:
    """inside_check_np's voxel cell of each point."""
    return np.round((pts - vox.translate) / vox.scale * vox.dims).astype(int)


# ---------------------------------------------------------------------------
# the scripts stand without JAX and default to the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("script", SCRIPTS)
def test_script_runs_help_with_jax_blocked(script):
    """Each script imports as a module and prints its help (with --device)
    in a process where jax, flax, optax, msgpack and morig_tpu cannot be
    imported."""
    code = textwrap.dedent(f"""
        import importlib.util, runpy, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        path = {os.path.join(ROOT, script)!r}
        spec = importlib.util.spec_from_file_location("m", path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        sys.argv = [path, "--help"]
        runpy.run_path(path, run_name="__main__")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout


@pytest.mark.parametrize("jax_script,script", [
    ("tools/sweep_joint_params.py", "tools/torch_sweep_joint_params.py"),
    ("tools/diagnose_joints.py", "tools/torch_diagnose_joints.py"),
    ("examples/capsule_end_to_end.py", "examples/torch_capsule_end_to_end.py"),
])
def test_flags_and_defaults_match_the_jax_tools(jax_script, script):
    """Each script's flags and defaults are its JAX counterpart's (read from
    its argparse lines, not imported), plus --device (default cuda), which
    takes the place of --platform where the JAX tool has one."""
    import re

    with open(os.path.join(ROOT, jax_script)) as f:
        src = f.read()
    jax_flags = dict(re.findall(r'add_argument\("(--[\w-]+)"[^)]*?default=("[^"]*"|[^,)]+)', src))
    jax_flags.update({flag: "False" for flag in re.findall(
        r'add_argument\("(--[\w-]+)", action="store_true"', src)})
    jax_flags.pop("--platform", None)          # diagnose_joints.py has none
    parser = _load(script, "m_" + os.path.basename(script)[:-3]).build_parser()
    got = {a.option_strings[0]: a.default for a in parser._actions if a.option_strings}
    assert got.pop("--device") == "cuda" and got.pop("-h") == "==SUPPRESS=="
    assert got == {flag: eval(default) for flag, default in jax_flags.items()}


@pytest.mark.parametrize("script,argv", [
    ("tools/torch_sweep_joint_params.py", ["--dir", "{tmp}"]),
    ("tools/torch_sweep_joint_params.py", ["--dir", "{tmp}", "--dump"]),
    ("tools/torch_diagnose_joints.py", ["--dir", "{tmp}"]),
    ("examples/torch_capsule_end_to_end.py", ["--out", "{tmp}", "--steps", "1"]),
])
def test_default_device_is_the_card(tmp_path, script, argv):
    """Without --device each entry point asks for cuda; with no card here
    that is an error, not a fall back to the CPU, raised before any work."""
    mod = _load(script, "m_" + os.path.basename(script)[:-3])
    assert mod.build_parser().parse_args([]).device == "cuda"
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main([a.format(tmp=tmp_path) for a in argv])
    assert os.listdir(tmp_path) == []
