"""The port's measurement and profiling scripts (`scripts/torch_{serve_bench,
batch_sweep,sa_bench,fps_parts_steptime,profile_train,profile_projection,
profile_parcel,trace_step,trace_raw,roofline}.py`, the JAX side's scripts of
those names through the port) on the CPU at tiny sizes, and what they rest on:

- the eval forward at 4,096 points (`bench.py`'s clouds; the port was
  compared at 256 and 2,048 before) against JAX's `pointnet2_forward(
  train=False)` on its exact XLA path, B=2 at PROD widths, weights carried
  by `load_jax_params`: atol 2e-5 on coverages and probabilities, as the
  serve parity tests (`test_torch_port_model.py`);
- FPS at 2, 4 and 8 parts with `fps_min_part_samples` 1 (the partitions
  `torch_fps_parts_steptime.py` runs) index for index JAX's
  `farthest_point_sampling(..., use_pallas=False)`;
- the roofline's counts (which `chip_smoke.py`'s site checks call too):
  each of PERF.md section 6's rows 1-12 at its PROD site within 1% of the
  bound there, and a finite bound at every site of the tiny steps;
- the trace aggregator (`utils/profiling.device_table`) on hand-made
  events, and its refusal of a card's trace without a device operation;
  `utils/profiling.trace` raising where the profiler cannot start, and
  the trace script's warm-up steps left out of its trace;
- every script raising where its default device, the card, is missing;
- phase 15m of `chip_smoke.py` (`tools_phase`) on the CPU.

The full-depth runs belong to the card (`chip_smoke.py` phase 15m and the
scripts' own runs, README)."""

import importlib.util
import json
import os
import re
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from stratanet2_tpu.config import ModelConfig as JaxModelConfig
from stratanet2_tpu.models import PointNet2Params, init_pointnet2 as jax_init, pointnet2_forward
from stratanet2_tpu.ops import farthest_point_sampling as jax_fps
from stratanet2_tpu_torch.config import ModelConfig, default_config
from stratanet2_tpu_torch.ops import cuda_kernels as ck
from stratanet2_tpu_torch.ops.ballquery import ball_query_grouped
from stratanet2_tpu_torch.ops.fps import farthest_point_sampling, fps_parts_taken
from stratanet2_tpu_torch.utils import profiling
from stratanet2_tpu_torch.utils.convert import from_jax_params
from stratanet2_tpu_torch.utils.synthetic import serve_batch

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
TOOLS = ("torch_serve_bench", "torch_batch_sweep", "torch_sa_bench",
         "torch_fps_parts_steptime", "torch_profile_train", "torch_profile_projection",
         "torch_profile_parcel", "torch_trace_step", "torch_trace_raw", "torch_roofline")


def script(name):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


rl = script("torch_roofline")


# ---------------------------------------------------------------------------
# parity with JAX: the forward at 4,096 points, FPS at 2, 4 and 8 parts
# ---------------------------------------------------------------------------


def test_forward_at_4096_points_matches_jax():
    """B=2 clouds of 4,096 points at PROD widths (k1=32, k2=64, SA1's FPS in
    2 parts of 512 picks, SA2's whole: 128 a part is below 256), BN scale,
    bias and running statistics random so that the fold is exercised."""
    n = 4096
    rng = np.random.default_rng(27)
    jcfg = JaxModelConfig(subsample_size=n, use_pallas=False)
    model = jax_init(jax.random.PRNGKey(27), jcfg)
    params = jax.tree_util.tree_map(np.asarray, model.params)
    state = jax.tree_util.tree_map(np.asarray, model.state)
    for name in state:
        for lp, ls in zip(params[name]["layers"], state[name]["layers"]):
            c = ls["mean"].shape[0]
            lp["bn"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            lp["bn"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
            ls["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            ls["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    jmodel = PointNet2Params(jax.tree_util.tree_map(jnp.asarray, params),
                             jax.tree_util.tree_map(jnp.asarray, state))
    xy = rng.uniform(-10, 10, (2, n, 2)).astype(np.float32)
    z = rng.uniform(0, 3, (2, n, 1)).astype(np.float32)
    xyz = np.concatenate([xy, z], -1)
    feats = np.concatenate([z / 24.24, rng.uniform(0, 1, (2, n, 7))], -1).astype(np.float32)
    cov, proba, _ = pointnet2_forward(jmodel, jnp.asarray(feats), jnp.asarray(xyz), jcfg,
                                      train=False)
    pcfg = ModelConfig(subsample_size=n)
    assert fps_parts_taken(n, pcfg.n_centroids1, pcfg.fps_parts, pcfg.fps_min_part_samples) == 2
    assert fps_parts_taken(pcfg.n_centroids1, pcfg.n_centroids2, pcfg.fps_parts,
                           pcfg.fps_min_part_samples) == 1
    port = from_jax_params(params, state, pcfg, device="cpu")
    with torch.no_grad():
        pcov, pproba = port(torch.from_numpy(feats), torch.from_numpy(xyz))
    np.testing.assert_allclose(pcov.numpy(), np.asarray(cov), rtol=0, atol=2e-5)
    np.testing.assert_allclose(pproba.numpy(), np.asarray(proba), rtol=0, atol=2e-5)


@pytest.mark.parametrize("parts", (2, 4, 8))
@pytest.mark.parametrize("n,s,b", [(10000, 2500, 1), (4096, 1024, 2)])
def test_fps_partitions_match_jax(parts, n, s, b):
    """Partitioned FPS with fps_min_part_samples 1 picks JAX's indices; at
    8 parts of 10,000 points (2,500 picks do not divide by 8) both run the
    cloud whole."""
    rng = np.random.default_rng(parts * n)
    xyz = rng.uniform(-10, 10, (b, n, 3)).astype(np.float32)
    want = np.asarray(jax_fps(jnp.asarray(xyz), s, use_pallas=False, parts=parts,
                              min_part_samples=1))
    got = farthest_point_sampling(torch.from_numpy(xyz), s, parts=parts, min_part_samples=1)
    np.testing.assert_array_equal(got.numpy(), want)
    taken = fps_parts_taken(n, s, parts, 1)
    assert taken == (1 if s % parts else parts)


@pytest.mark.parametrize("cfg,want", [
    # (B, N, fps_parts, fps_min_part_samples) -> SA1's and SA2's (rows, points, picks)
    ((20, 10000, 2, 256), [(40, 5000, 1250), (20, 2500, 625)]),  # PROD
    ((20, 10000, 4, 1), [(80, 2500, 625), (20, 2500, 625)]),
    ((20, 10000, 8, 1), [(20, 10000, 2500), (20, 2500, 625)]),
    ((128, 4096, 2, 256), [(256, 2048, 512), (128, 1024, 256)]),  # bench.py's geometry
])
def test_fps_rows_of_the_tools_geometries(cfg, want):
    """The rows each SA's FPS runs at the geometries the tools drive, by
    `torch_fps_parts_steptime.fps_rows` (the rule of `ops/fps.py`)."""
    b, n, parts, least = cfg
    fp = script("torch_fps_parts_steptime")
    c = fp.parts_config(parts, b, n)
    c = replace(c, model=replace(c.model, fps_min_part_samples=least))
    assert [(rows, pts, picks) for _, rows, pts, picks in fp.fps_rows(c)] == want


# ---------------------------------------------------------------------------
# the roofline's counts
# ---------------------------------------------------------------------------

# PERF.md section 6's bound column (ms) of rows 1-12, per step at PROD
PERF_BOUNDS = {"1": 0.04194, "2": 0.08801, "3": 0.01672, "4": 0.07929, "5": 0.09461,
               "6": 0.002025, "7": 0.001013, "8": 0.007165, "9": 0.01725, "10": 0.03930,
               "11": 0.03458, "12": 0.004701}


@pytest.fixture(scope="module")
def prod_valid():
    """The valid picks of SA1 and SA2 on a PROD batch of 20 uniform serve
    clouds, counted on 2 of them and scaled: the only data-dependent terms
    of rows 5 and 8-11 (a new draw moves them by ~0.1%)."""
    cfg = ModelConfig()
    cloud, xyz = serve_batch(2, cfg.subsample_size, torch.Generator().manual_seed(0),
                             torch.device("cpu"))
    rows = torch.arange(2)[:, None]
    c1 = xyz[rows, farthest_point_sampling(xyz, cfg.n_centroids1, parts=2).long()]
    c2 = c1[rows, farthest_point_sampling(c1, cfg.n_centroids2, parts=2).long()]
    return (float(ball_query_grouped(c1, xyz, cfg.r1, cfg.k1)[1].sum()) * 10,
            float(ball_query_grouped(c2, c1, cfg.r2, cfg.k2)[1].sum()) * 10)


def prod_counts(row, v1, v2):
    """Row `row`'s counts a PROD step: serve rows at the serve step's two
    sites, train rows at the train step's, row 12 at the nearest serve
    step's (shapes of PROD's B=20 x 10,000, 2,500 and 625 centroids)."""
    b = 20
    sites = {
        "1": [rl.fps_counts(2 * b, 5000, 1250), rl.fps_counts(b, 2500, 625)],
        "2": [rl.knn_interpolate_counts(b, 625, 2500, 64),
              rl.knn_interpolate_counts(b, 2500, 10000, 34)],
        "3": [rl.knn_scatter_counts(b, 3, 10000, 2500, 34, True),
              rl.knn_scatter_counts(b, 3, 2500, 625, 64, True)],
        "4": [rl.ball_query_counts(b, 2500, 10000, 32), rl.ball_query_counts(b, 625, 2500, 64)],
        "5": [rl.sa_fused_eval_counts(b, 10000, 2500, 32, 16, 16, True, v1),
              rl.sa_fused_eval_counts(b, 2500, 625, 64, 32, 32, False, v2)],
        "6": [rl.pixel_max_counts(b, 10000, 3, 400)] * 2,
        "7": [rl.pixel_max_bwd_counts(b, 10000, 3, 400)],
        "8": [rl.sa_train_stats_counts(b, 10000, 2500, 32, 16, v1)],
        "9": [rl.sa_train_main_counts(b, 10000, 2500, 32, 16, 16, True, v1),
              rl.sa_train_main_counts(b, 2500, 625, 64, 32, 32, False, v2)],
        "10": [rl.sa_train_bwd1_counts(b, 10000, 2500, 32, 16, 16, v1)],
        "11": [rl.sa_train_bwd2_counts(b, 10000, 2500, 32, 16, 16, True, v1),
               rl.sa_train_bwd2_counts(b, 2500, 625, 64, 32, 32, False, v2)],
        # the nearest route's bound is its bytes; its in-radius pairs are not needed
        "12": [rl.ball_query_nearest_counts(b, 2500, 10000, 32, 0.0),
               rl.ball_query_nearest_counts(b, 625, 2500, 64, 0.0)],
    }[row]
    total = sites[0]
    for c in sites[1:]:
        total = total + c
    return total


@pytest.mark.parametrize("row", sorted(PERF_BOUNDS, key=int))
def test_roofline_reproduces_the_perf_table_at_prod(row, prod_valid):
    ms, by = rl.bound_ms(*prod_counts(row, *prod_valid))
    assert ms == pytest.approx(PERF_BOUNDS[row], rel=0.01)
    assert by == ("bytes" if row in ("3", "6", "7", "8", "12") else "operations")


def test_roofline_rows_name_every_wrapper_once():
    assert sorted(rl.ROWS) == sorted(ck.WRAPPERS)
    assert sorted((int(r) for r, _ in rl.ROWS.values())) == list(range(1, 13))


@pytest.fixture(scope="module")
def tiny_sites():
    cfg = default_config()
    cfg = replace(cfg, model=replace(cfg.model, subsample_size=512),
                  train=replace(cfg.train, batch_size=2))
    return rl.step_sites(cfg, torch.device("cpu"))


def test_roofline_records_every_site_of_the_steps(tiny_sites):
    """The roofline's sites are every launch of the tiny serve, train and
    nearest steps (the smoke's launch vectors), each with bytes and a
    finite bound."""
    assert {name: len(calls) for name, calls in tiny_sites.items()} == {
        **{k: v for k, v in cs.SERVE_LAUNCHES.items() if k in rl.ROWS and rl.ROWS[k][1] == "serve"},
        **{k: v for k, v in cs.TRAIN_LAUNCHES.items() if rl.ROWS[k][1] == "train"},
        "ball_query_nearest": 2}
    seen = 0
    with torch.inference_mode():  # the serve sites' tensors are inference tensors
        for name, calls in tiny_sites.items():
            for args in calls:
                counts, shape = rl.site_counts(name, args)
                ms, by = rl.bound_ms(*counts)
                assert counts.bytes > 0 and 0 < ms < float("inf") and shape, name
                assert by in ("bytes", "operations")
                seen += 1
    assert seen == 21  # 8 serve sites, 2 nearest, 11 train


# ---------------------------------------------------------------------------
# the trace aggregator
# ---------------------------------------------------------------------------


def kernel(name, ts, dur, **args):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "tid": 7,
            "args": args}


def test_device_table_groups_sums_per_step_and_reports_the_idle_share():
    events = [kernel("void fps_kernel<16, 4>", 0, 400.0), kernel("void knn_kernel", 500, 100.0),
              kernel("void fps_kernel<16, 4>", 1000, 300.0),
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1400, "dur": 20.0},
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 900.0},
              {"ph": "X", "cat": "gpu_user_annotation", "name": "Optimizer.step", "ts": 0,
               "dur": 2000.0},
              {"ph": "i", "cat": "kernel", "name": "instant", "ts": 0}]
    ops = [ev for ev in events if profiling.is_device_op(ev)]
    assert [ev["name"] for ev in ops] == ["void fps_kernel<16, 4>", "void knn_kernel",
                                         "void fps_kernel<16, 4>", "Memcpy HtoD"]
    table = profiling.device_table(ops, steps=2, step_ms=0.5)
    assert table.rows == [(0.35, 1.0, "void fps_kernel<16, 4>"), (0.05, 0.5, "void knn_kernel"),
                          (0.01, 0.5, "Memcpy HtoD")]
    assert table.busy_ms == pytest.approx(0.41)
    assert table.idle_share == pytest.approx(1 - 0.41 / 0.5)
    assert profiling.device_table(ops, steps=2).idle_share is None


def test_device_table_refuses_a_card_trace_without_device_operations():
    with pytest.raises(RuntimeError, match="no device operation"):
        profiling.device_table([], steps=3, step_ms=2.0)
    cpu_ops = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 5.0, "tid": 1}]
    with pytest.raises(RuntimeError, match="no device operation"):
        profiling.device_table([ev for ev in cpu_ops if profiling.is_device_op(ev)], steps=1)
    table = profiling.device_table(cpu_ops, steps=1, device="cpu")
    assert table.rows == [(0.005, 1.0, "aten::mm")]


def test_outermost_keeps_the_spans_no_other_holds():
    spans = [{"name": "outer", "ts": 0, "dur": 10, "tid": 1},
             {"name": "inner", "ts": 2, "dur": 3, "tid": 1},
             {"name": "next", "ts": 10, "dur": 1, "tid": 1},
             {"name": "other thread", "ts": 3, "dur": 1, "tid": 2}]
    assert [ev["name"] for ev in profiling.outermost(spans)] == ["outer", "next", "other thread"]


def test_load_trace_reads_the_newest_and_trace_raw_links_shapes(tmp_path):
    """`load_trace` reads the newest trace under a folder; the raw view
    gives a kernel its launch configuration and the shapes of the operator
    its External id names, and refuses a card trace without a kernel."""
    raw = script("torch_trace_raw")
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 50.0, "tid": 1,
               "args": {"External id": 4, "Input Dims": [[20, 64], [64, 32]]}},
              kernel("void gemm", 10, 30.0, grid=[4, 1, 1], block=[128, 1, 1],
                     **{"External id": 4}),
              kernel("void fps_kernel", 60, 90.0, grid=[40, 1, 1], block=[1024, 1, 1])]
    (tmp_path / "old").mkdir()
    (tmp_path / "old" / "a.pt.trace.json").write_text(json.dumps({"traceEvents": []}))
    os.utime(tmp_path / "old" / "a.pt.trace.json", (1, 1))
    (tmp_path / "b.pt.trace.json").write_text(json.dumps({"traceEvents": events}))
    assert profiling.load_trace(str(tmp_path)) == events
    rows = raw.raw_rows(events, "cuda", steps=2)
    assert rows == [(0.045, "void fps_kernel", "grid=[40, 1, 1] block=[1024, 1, 1]"),
                    (0.015, "void gemm", "grid=[4, 1, 1] block=[128, 1, 1] "
                                         "aten::mm[[20, 64], [64, 32]]")]
    assert raw.raw_rows(events, "cpu", steps=1) == [(0.05, "aten::mm", "[[20, 64], [64, 32]]")]
    with pytest.raises(RuntimeError, match="no device operation"):
        raw.raw_rows(events[:1], "cuda", steps=1)
    with pytest.raises(FileNotFoundError):
        profiling.load_trace(str(tmp_path / "empty"))


def test_trace_yields_its_profiler_and_raises_where_it_cannot_start(tmp_path, monkeypatch):
    """`utils/profiling.trace` yields its profiler and writes the trace
    `load_trace` reads; where the profiler cannot start it raises (no
    measurement goes on without it)."""
    with profiling.trace(str(tmp_path / "t")) as prof:
        assert prof is not None
        torch.ones(3).sum()
    assert any(profiling.is_device_op(ev, "cpu") for ev in profiling.load_trace(str(tmp_path)))

    class Broken:
        def __init__(self, *a, **k):
            pass

        def start(self):
            raise RuntimeError("CUPTI unavailable")

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    with pytest.raises(RuntimeError, match="trace unavailable"):
        with profiling.trace(str(tmp_path / "u")):
            pass


def test_trace_step_leaves_its_warmup_steps_out(tmp_path):
    """`torch_trace_step.traced_events` with `warmup` (the smoke's dense
    step profiles): the warm-up calls run under the profiler's warm-up and
    only the traced calls' operators are in the trace."""
    ts = script("torch_trace_step")
    calls = iter([lambda: torch.mm(torch.ones(4, 4), torch.ones(4, 4))] * 2
                 + [lambda: torch.add(torch.ones(3), 1)] * 3)
    events = ts.traced_events(lambda: next(calls)(), 3, str(tmp_path / "w"), "cpu", warmup=2)
    names = [ev["name"] for ev in events]
    assert names.count("aten::add") == 3 and "aten::mm" not in names


# ---------------------------------------------------------------------------
# the scripts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", TOOLS)
def test_each_script_raises_without_the_card(name, tmp_path):
    """With its default device (the card) and none on the machine, every
    script raises; none carries on on the CPU. The raw trace view, given a
    trace without a device operation, raises too."""
    if name == "torch_trace_raw":
        (tmp_path / "x.pt.trace.json").write_text(json.dumps({"traceEvents": [
            {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 1.0}]}))
        with pytest.raises(RuntimeError, match="no device operation"):
            script(name).main(["--logdir", str(tmp_path)])
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script(name).main([])


TINY = {
    "torch_serve_bench": (["--batch", "2", "--subsample", "512", "--iters", "1"],
                          [r"PROD serve eval fwd b=2x512: .*M pts/s .* ms/step chained wall\) "
                           r"\[CPU time\]", r"PROD serve step \(fwd \+ projections\) b=2x512"]),
    "torch_batch_sweep": (["2", "3", "--subsample", "512", "--iters", "1"],
                          [r"b=   2 iters=   1: .*M pts/s .* ms/step\) \[CPU time\]",
                           r"b=   3 iters=   1: "]),
    "torch_sa_bench": (["--batch", "1", "--subsample", "512", "--iters", "1"],
                       [r"SA1 b=1 n=512 c=128 k=32 .* ms/call \[CPU time\]",
                        r"SA2 b=1 n=128 c=32 k=64 ", r"TOTAL sa_fused .* ms"]),
    "torch_fps_parts_steptime": (["--parts", "4", "8", "--batch", "2", "--subsample", "1024",
                                  "--iters", "1"],
                                 [r"fps_parts=4: .* ms/step chained \(.*M pts/s\) \[CPU time\]",
                                  r"SA1 FPS: parts=4 rows=8 points/row=256 picks/row=64",
                                  r"SA2 FPS: parts=4 rows=8 points/row=64 picks/row=16",
                                  r"fps_parts=8: ", r"SA1 FPS: parts=8 rows=16 points/row=128"]),
    "torch_profile_train": (["--batch", "2", "--subsample", "512", "--iters", "1"],
                            [r"PROD geometry b=2 x n=512, device=cpu \(CPU times\)",
                             r"fps1 \(512->128\)", r"ball_query2 \(32x128, K=64\)",
                             r"SA1 fwd\+bwd train", r"kNN FP1 fwd\+bwd",
                             r"full forward train=False", r"FULL TRAIN STEP"]),
    "torch_profile_projection": (["--batch", "2", "--n", "300", "--iters", "1"],
                                 [r"b=2 n=300 P=20, device=cpu \(CPU times\)",
                                  r"plotwise fwd\+bwd +[0-9.]+ ms",
                                  r"raster projection fwd +[0-9.]+ ms"]),
    "torch_profile_parcel": (["--n_pts", "4000", "--side", "25", "--subsample", "256"],
                             [r"prepare: [0-9.]+s for \d+ plots", r"cumtime",
                              r"predict\+mosaic: [0-9.]+s"]),
    "torch_roofline": (["--batch", "2", "--subsample", "512", "--diam_pix", "30"],
                       [r"device: cpu", r"B=2 x N=512 diam_pix=30",
                        r"  1 fps +2 .* operations +not measured +not measured",
                        r"rows=2 N=512 S=128: bound [0-9.e-]+ ms\n", r" 12 ball_query_nearest +2 ",
                        r"B=2 N=512 C=3 P2=900: bound"]),
}


@pytest.mark.parametrize("name", sorted(TINY))
def test_script_runs_on_the_cpu(name, capsys, monkeypatch):
    """Each script's `main` at a tiny size on the CPU prints its lines, its
    times labelled as the CPU's."""
    from stratanet2_tpu_torch.data import native

    monkeypatch.setattr(native, "available", lambda: False)  # no native build here
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    args, lines = TINY[name]
    assert script(name).main([*args, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for line in lines:
        assert re.search(line, out), (line, out[-2000:])


@pytest.mark.parametrize("eager", (False, True))
def test_trace_step_and_raw_run_on_the_cpu(tmp_path, capsys, eager):
    """The train step (its step, or with `--eager` its body) traced at a
    tiny size: its table, the idle share not measured on the CPU, and the
    trace it wrote read back by the raw view with the operators' shapes."""
    logdir = str(tmp_path / "trace")
    args = ["--batch", "2", "--subsample", "256", "--steps", "1", "--top", "5",
            "--logdir", logdir, "--device", "cpu", *(["--eager"] if eager else [])]
    assert script("torch_trace_step").main(args) == 0
    out = capsys.readouterr().out
    assert re.search(r"op \(outermost CPU operators\) +ms/step", out)
    assert re.search(r"TOTAL \(CPU time\) +[0-9.]+", out)
    assert re.search(r"idle share .* not measured", out)
    assert script("torch_trace_raw").main(["--logdir", logdir, "--steps", "1", "--top", "5",
                                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].split()[:3] == ["ms/step", "op", "shapes"] and len(out) == 6
    assert any(re.search(r"\[\[2, 256, \d+\]", line) for line in out[1:])


def test_tools_phase_runs_on_the_cpu(monkeypatch, capsys):
    """Phase 15m's control flow on the CPU at small sizes (4 clouds of 512
    points served whole and in batches of 2, a train step of 2 x 1,024 at
    4 parts, the trace and the roofline at 2 x 512): its lines in order,
    the sites held (here the plain versions on both sides: equal), the
    batches equal to the whole, the rows of each FPS the rule's, and the
    launch checks (the plain versions run, so those are let through, one a
    kernel of each counted run); `main` runs it after phase 15l with a
    timeline line."""
    import inspect

    check, missed = cs.check, []

    def lenient(cond, msg):
        if not cond and re.search(r"launched 0 times .*expected [1-9]", msg):
            missed.append(msg)
            return
        check(cond, msg)

    monkeypatch.setattr(cs, "check", lenient)
    cs.tools_phase(torch, ck, "cpu", device="cpu",
                   small={"serve": (4, 512, 2), "train": (2, 1024), "prod": (2, 512)})
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    ours = [x for x in lines if x["phase"].startswith("tools")
            and not x["phase"].endswith("_launches")]
    assert [x["phase"] for x in ours] == (["tools_site"] * 6 + ["tools_b128", "tools_fps_parts",
                                          "tools_trace"] + ["tools_roofline"] * 12
                                          + ["tools_roofline_seconds", "tools"])
    sites = ours[:6]
    assert [x["kernel"] for x in sites] == ["fps"] * 2 + ["sa_fused_eval"] * 2 + \
        ["knn_interpolate"] * 2
    assert all(x["differing_selections"] == 0 and x["max_abs_diff"] == 0.0 for x in sites)
    assert sites[0]["shape"].startswith("rows=4 N=512 S=128")  # 64 a part: whole
    b128, parts, trace = ours[6:9]
    assert b128["batches_vs_whole_max_abs_diff"] <= cs.CPU_ATOL and b128["finite"]
    assert [r["rows"] for r in parts["fps_rows"]] == [8, 8]
    assert trace["idle_share"] is None and trace["top"]
    assert [x["row"] for x in ours[9:21]] == [str(r) for r in range(1, 13)]
    assert all(x["ms"] == "not measured" and x["bound_ms"] > 0 for x in ours[9:21])
    assert ours[-1]["budget_seconds"] == cs.TOOLS_BUDGET_S
    want = len(cs.TOOLS_FORWARD_LAUNCHES) + sum(1 for v in cs.TRAIN_LAUNCHES.values() if v)
    assert len(missed) == want
    src = inspect.getsource(cs.main)
    order = ['cap_studies_phase(', 'timeline("cap_studies")', 'tools_phase(',
             'timeline("tools")', 'parcel_phase(']
    assert [src.index(x) for x in order] == sorted(src.index(x) for x in order)
