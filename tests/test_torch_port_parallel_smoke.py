"""Phase 15g of chip_smoke.py (`parallel_phase`) on the CPU at a small size:
its two gloo ranks with their checks (the point-sharded serve step against
its ranks on the CPU, the aligned geometry against the single-process
step, the train steps against theirs, params equal across ranks,
`train_full` on both paths) and the four torchrun CLI runs with their
artifacts (the dryrun is test_torch_port_parallel.py's: here a stub
records the call). On the CPU the kernels' plain versions run, so the
checks that a path's kernels launched are the ones let through. matplotlib
is hidden from this process and those it starts (`no_figures`): the
figures are not what the phase checks."""

import json
import sys

import torch

import chip_smoke as cs
from stratanet2_tpu_torch.ops import cuda_kernels as ck
from stratanet2_tpu_torch.parallel import dryrun
from test_torch_port_parallel import no_figures

SMALL = {  # N=264 is not aligned with k1=32 (groups of 9), N=256 is
    "rank": {"B": 4, "N": 264, "N_aligned": 256, "plots": 10, "points": 600},
    "flags": ("--subsample_size", "264", "--batch_size", "4"),
}


def test_parallel_phase_runs_on_the_cpu(monkeypatch, capsys, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    no_figures(monkeypatch, tmp_path)
    monkeypatch.setattr(cs, "CLI_PLOTS", 12)
    monkeypatch.setattr(cs, "CLI_POINTS", 600)
    monkeypatch.setattr(cs, "PARCEL_DENSITY", 8.0)
    check = cs.check
    missed = []

    def lenient(cond, msg):
        if not cond and "launched" in msg:
            missed.append(msg)
            return
        check(cond, msg)

    monkeypatch.setattr(cs, "check", lenient)
    dryruns = []  # the dryrun itself is test_torch_port_parallel.py's
    monkeypatch.setattr(dryrun, "dryrun_multichip", lambda *a: dryruns.append(a) or {})
    cs.parallel_phase(torch, ck, "cpu", device="cpu", small=SMALL)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    phases = [x["phase"] for x in lines]
    assert phases.count("parallel_step") == 8 and phases.count("parallel_train_full") == 2
    (summary,) = [x for x in lines if x["phase"] == "parallel"]
    assert summary["ps_serve_cpu_diff"] <= cs.CPU_ATOL
    assert summary["ps_train_vs_unfused"]["state"] <= cs.TRAIN_STATE_ATOL
    assert dryruns == [(2, "gloo", "cpu")] and "parallel_dryrun" in phases
    assert [x["cli"] for x in lines if x["phase"] == "parallel_cli"] == [
        "main_point_sharded", "main_data_parallel", "predict_point_sharded",
        "predict_data_parallel"]
    # the launch checks of the four steps that want a kernel launched, on
    # each rank: 4 serve kernels twice, 6 point-sharded and 10 fused train
    # kernels (the CLIs' checks let a CPU run through themselves)
    assert len(missed) == 2 * (4 + 4 + 6 + 10)
