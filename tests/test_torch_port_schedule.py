"""The port's training-schedule tools on the CPU against the JAX side's:
`stratanet2_tpu_torch/utils/synthetic.make_learnable_plot` against
`scripts/learnability_check.py`'s bit for bit,
`scripts/torch_learnability_check.py` at a tiny size, and
`scripts/torch_prod_schedule_run.py`'s orchestration at
`tests/test_schedule_orchestration.py`'s tiny scale (20 plots of 600
points, batch 4, subsample 256, 8 epochs, an eval every epoch, fold 1 killed
after epoch 3): the kill lands mid-schedule and the resumed fold 1 equals an
unbroken one bit for bit. Both scripts import with jax and the JAX package
blocked. The children run on the CPU (`--device cpu`) with matplotlib and
scikit-learn hidden from them (their figures are skipped with a warning)."""

import argparse
import ast
import importlib.util
import json
import os
import pickle
import re
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
# the orchestration's tiny scale, as tests/test_schedule_orchestration.py's
TINY = ["--plots", "20", "--points", "600", "--batch", "4", "--subsample", "256",
        "--n_epoch", "8", "--n_epoch_test", "1", "--device", "cpu"]
TIMEOUT = 600.0


def load_script(name):
    """`scripts/<name>.py` loaded by path as a module."""
    spec = importlib.util.spec_from_file_location(f"_script_{name}", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_learn = load_script("learnability_check")
learn = load_script("torch_learnability_check")
sched = load_script("torch_prod_schedule_run")


def summary_keys(script: str, marker: str):
    """The keys of the dict a JAX script prints after `marker` (its summary
    line), read from its source."""
    tree = ast.parse((SCRIPTS / script).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and node.keys and all(
                isinstance(k, ast.Constant) for k in node.keys):
            keys = {k.value for k in node.keys}
            if marker in keys:
                return keys
    raise AssertionError(f"no summary dict with {marker!r} in {script}")


JAX_LEARNABILITY_KEYS = summary_keys("learnability_check.py", "baseline_MAE")
JAX_FOLD_KEYS = summary_keys("prod_schedule_run.py", "mean_baseline_MAE")


def quiet(monkeypatch, folder):
    """matplotlib and scikit-learn hidden from this process and from the
    children it starts (a package of each name under `folder`, first on
    their PYTHONPATH, raises ImportError: the port skips its figures and
    confusion matrices with a warning), two threads a child."""
    stubs = folder / "hidden"
    for name in ("matplotlib", "sklearn"):
        (stubs / name).mkdir(parents=True)
        (stubs / name / "__init__.py").write_text(f'raise ImportError("{name} is hidden")\n')
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setenv("PYTHONPATH", str(stubs) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


@pytest.fixture
def quiet_children(monkeypatch, tmp_path):
    quiet(monkeypatch, tmp_path)


@pytest.mark.parametrize("n", [600, 3000])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_make_learnable_plot_equals_the_jax_scripts(seed, n):
    """The same draws in the same order: cloud and ground truth bit for bit,
    and the generator left in the same state."""
    from stratanet2_tpu_torch.utils.synthetic import make_learnable_plot

    rng_want, rng_got = np.random.default_rng(seed), np.random.default_rng(seed)
    for i in range(2):
        want = jax_learn.make_learnable_plot(rng_want, n=n, center=(100.0 * i, 0.0))
        got = make_learnable_plot(rng_got, n=n, center=(100.0 * i, 0.0))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    assert got[0].shape == (10, n)
    assert rng_got.bit_generator.state == rng_want.bit_generator.state


def test_learnability_check_on_the_cpu(quiet_children, capsys):
    """The check at a tiny size on the CPU: its plots are the JAX script's,
    it prints `LEARNABILITY_SUMMARY` with the JAX script's keys, and it
    passes exactly when val MAE beats the mean baseline."""
    dataset = learn.make_dataset(10, 0)
    rng = np.random.default_rng(0)
    for i, (pid, item) in enumerate(sorted(dataset.items())):
        cloud, gt = jax_learn.make_learnable_plot(rng, center=(100.0 * i, 0.0))
        assert pid == f"L{i:03d}" and item["index"] == i
        np.testing.assert_array_equal(item["cloud"], cloud)
        np.testing.assert_array_equal(item["coverages"], gt)

    try:
        learn.main(["--device", "cpu", "--n_plots", "10", "--epochs", "4",
                    "--subsample_size", "256"])
        failed = False
    except SystemExit as err:
        assert "baseline" in str(err)
        failed = True
    out = capsys.readouterr().out
    (line,) = [x for x in out.splitlines() if x.startswith("LEARNABILITY_SUMMARY ")]
    summary = json.loads(line.split(" ", 1)[1])
    assert JAX_LEARNABILITY_KEYS <= set(summary)
    assert (summary["epochs"], summary["n_plots"], summary["device"]) == (4, 10, "cpu")
    assert all(np.isfinite(summary[k]) for k in ("val_MAE", "baseline_MAE", "train_MAE_first"))
    beats = summary["val_MAE"] < summary["baseline_MAE"]
    assert failed is not beats
    assert ("LEARNABILITY CHECK PASSED" in out) is beats


def _perturbed(src, dst):
    """A copy of the root `src` with one parameter of fold 1's best
    checkpoint and one loss part of its last run changed."""
    shutil.copytree(src, dst)
    fold = dst / "fold1"
    path = fold / "PCC_model_fold_n=1.pt"
    payload = pickle.loads(path.read_bytes())
    leaf = payload["params"]
    while not isinstance(leaf, np.ndarray):
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf[0]
    leaf.flat[0] = np.nextafter(leaf.flat[0], np.float32(np.inf))
    path.write_bytes(pickle.dumps(payload))
    losses = dst / "fold1_losses.jsonl"
    runs = [json.loads(x) for x in losses.read_text().splitlines()]
    runs[-1]["train"][-1]["MAE_loss"] += 1e-9
    losses.write_text("".join(json.dumps(r) + "\n" for r in runs))


def test_orchestration_kills_resumes_and_equals_an_unbroken_fold(quiet_children, tmp_path,
                                                                 capfd):
    """Fold 1 killed by SIGTERM past epoch 3 of 8 and resumed in a new
    process from its `.resume` checkpoint, then fold 2; an unbroken fold 1
    runs beside them in a fresh root. The resumed fold equals the unbroken
    one bit for bit (the tensors and losses phase 15j compares), and
    `compare_runs` finds one changed parameter and one changed loss."""
    root, ref = tmp_path / "schedule", tmp_path / "unbroken"
    ns = sched.parse_args(["--root", str(root), "--kill_after", "3", *TINY])
    sched.build_dataset(str(root), ns.plots, ns.points)
    ref.mkdir()
    shutil.copy(root / "plots.pkl", ref)
    with sched.child(ns, str(ref), 1) as unbroken:
        runs = sched.orchestrate(ns, timeout=TIMEOUT)
        assert unbroken.wait(TIMEOUT) == 0
    out = capfd.readouterr().out
    assert "KILLING fold-1 run" in out and "fold 2 exit code 0" in out

    killed, resumed, fold2 = runs
    assert killed["run"] == "killed" and killed["exit_code"] == -signal.SIGTERM
    assert 3 <= killed["killed_after_epoch"] < 8
    assert resumed["killed_after_epoch"] == killed["killed_after_epoch"]
    assert 1 < resumed["resumed_from_epoch"] <= killed["killed_after_epoch"] + 1
    assert resumed["last_epoch"] == 8 and resumed["resumed"]
    assert (fold2["fold"], fold2["epochs_run"], fold2["resumed"]) == (2, 8, False)
    for run in (resumed, fold2):
        assert JAX_FOLD_KEYS <= set(run)
        assert (run["B"], run["N"], run["train_plots"], run["val_plots"]) == (4, 256, 16, 4)
        assert run["train_batches"] == 4 * run["epochs_run"]
        assert run["evals"] == run["epochs_run"] + 1 == run["eval_batches"]
        assert set(run["launches"].values()) == {0}  # the CPU: plain versions
    printed = [json.loads(x.split(" ", 1)[1]) for x in out.splitlines()
               if x.startswith("FOLD_SUMMARY ")]
    assert sorted((r["fold"], r["resumed"]) for r in printed) == [(1, False), (1, True),
                                                                  (2, False)]
    written = [json.loads(x) for x in (root / "fold1_summary.json").read_text().splitlines()]
    assert written == [{k: v for k, v in resumed.items()
                        if k not in ("run", "process_seconds")}]
    assert resumed["process_seconds"] > resumed["wall_seconds"]
    split = resumed["seconds_split"]
    assert split["epochs"] > split["first_epoch"] > 0 and split["between_epochs"] > 0
    assert sum(split[k] for k in ("setup", "epochs", "between_epochs", "final")) == pytest.approx(
        resumed["wall_seconds"], abs=0.5)

    cmp = sched.compare_runs(str(root), str(ref), 1)
    assert sched.same_run(cmp), cmp
    assert cmp["tensors"] > 100 and cmp["max_abs_diff"] == 0.0
    assert cmp["train_epochs_compared"] == 9 - cmp["resumed_from_epoch"]
    assert cmp["evals_compared"] == cmp["train_epochs_compared"] + 1

    _perturbed(ref, tmp_path / "perturbed")
    off = sched.compare_runs(str(root), str(tmp_path / "perturbed"), 1)
    assert (off["differing_tensors"], off["differing_losses"]) == (1, 1)
    assert not sched.same_run(off)


def test_orchestration_fails_when_fold_1_ends_before_the_kill(quiet_children, tmp_path,
                                                             monkeypatch):
    """A fold 1 that ends (here after 2 epochs) before the kill epoch (3)
    fails the orchestration: no resume is exercised."""
    ns = sched.parse_args(["--root", str(tmp_path), "--kill_after", "3", *TINY,
                           "--plots", "10", "--points", "300", "--batch", "2"])
    real = sched.child_args

    def two_epochs(ns, root, fold, resume=False):
        return real(argparse.Namespace(**{**vars(ns), "n_epoch": 2}), root, fold, resume)

    monkeypatch.setattr(sched, "child_args", two_epochs)
    with pytest.raises(RuntimeError, match="before epoch 3: the kill never landed"):
        sched.orchestrate(ns, timeout=TIMEOUT)
    assert sched.train_epochs(str(tmp_path / "fold1" / "metrics.jsonl"), 1) == [1, 2]


def test_parse_folds():
    assert sched.parse_folds("1-5") == [1, 2, 3, 4, 5]
    assert sched.parse_folds("1,3") == [1, 3]
    assert sched.parse_folds("2") == [2]


def test_fold_split_is_the_jax_scripts():
    """Fold f's val plots are the contiguous ids[(f - 1) n_val : f n_val]
    (prod_schedule_run.py:119-122), so the folds hold RESULTS.md's plots."""
    ids = np.array([f"P{i:03d}" for i in range(110)])
    for fold in range(1, 6):
        train, val = sched.fold_split(ids, fold)
        assert list(val) == list(ids[(fold - 1) * 22:fold * 22])
        assert sorted(set(train) | set(val)) == list(ids) and len(train) == 88


PORT_SCRIPTS = ("torch_learnability_check", "torch_prod_schedule_run", "torch_ssl_cycle",
                "torch_learnability_sweep", "torch_neighbor_cap_study", "torch_cap_train_study",
                "torch_parity_eval", "torch_serve_bench", "torch_batch_sweep", "torch_sa_bench",
                "torch_fps_parts_steptime", "torch_profile_train", "torch_profile_projection",
                "torch_profile_parcel", "torch_trace_step", "torch_trace_raw", "torch_roofline")


def test_scripts_import_without_jax(tmp_path):
    """The port's four training-schedule scripts, its capped-K studies, its
    parity evaluation and its ten measurement and profiling tools, and
    every module their functions import, load with jax and the JAX package
    blocked, in a fresh interpreter."""
    modules = sorted({
        node.module if isinstance(node, ast.ImportFrom) else alias.name
        for name in (f"{script}.py" for script in PORT_SCRIPTS)
        for node in ast.walk(ast.parse((SCRIPTS / name).read_text()))
        if isinstance(node, (ast.Import, ast.ImportFrom)) and not getattr(node, "level", 0)
        for alias in node.names})
    assert {"stratanet2_tpu_torch.learning.train", "stratanet2_tpu_torch.cli",
            "torch_learnability_check", "torch_prod_schedule_run",
            "stratanet2_tpu_torch.utils.reference_oracle",
            "stratanet2_tpu_torch.learning.evaluate"} <= set(modules)
    assert not [m for m in modules if re.match(r"(jax|stratanet2_tpu)(\.|$)", m)]
    code = (
        "import importlib, importlib.util, sys\n"
        "blocked = ('jax', 'jaxlib', 'stratanet2_tpu')\n"
        "for m in blocked:\n"
        "    sys.modules[m] = None\n"
        f"for name in {PORT_SCRIPTS!r}:\n"
        f"    spec = importlib.util.spec_from_file_location(name, {str(SCRIPTS)!r} + f'/{{name}}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "loaded = [m for m, v in sys.modules.items() if v is not None\n"
        "          and m.split('.')[0] in blocked]\n"
        "assert not loaded, loaded\n"
        "print('imported')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "imported" in out.stdout, out.stderr
