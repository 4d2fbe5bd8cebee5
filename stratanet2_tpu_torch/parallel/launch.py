"""Start ranks as processes of this machine and collect what each returns.

`run_ranks(world, target, payload)` starts `world` interpreters, each
`python -m stratanet2_tpu_torch.parallel.launch <workdir> <rank>`, with
the environment `multihost.initialize` reads (RANK, WORLD_SIZE, LOCAL_RANK
and JAX_COORDINATOR_ADDRESS as a `file://` rendezvous under the work
directory: no port is taken). Each rank joins the group on the backend the
caller names, calls `target(payload, device)` (a function named
"module:name", imported by the rank: ranks import torch and the port,
nothing else) on its device (`multihost.rank_device`: the device as given,
a bare "cuda" being the rank's own card) and pickles its return value. The parent waits at most `timeout` seconds; if a
rank fails or the time runs out it ends every rank still running and
raises with the end of each rank's output.
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, List, Optional

from stratanet2_tpu_torch.device import resolve_device

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_ranks(
    world: int,
    target: str,
    payload: Any = None,
    *,
    backend: str,
    device: Optional[str] = None,
    timeout: float = 300.0,
    workdir: Optional[str] = None,
) -> List[Any]:
    """[rank r's return value for r in range(world)]. `device` defaults to
    the card ("cuda", one card a rank) and raises without one, as
    `resolve_device` does; the CPU is asked for with "cpu". Each rank
    computes on one host thread."""
    device = str(resolve_device(device))
    own = workdir is None
    tmp = tempfile.TemporaryDirectory() if own else None
    workdir = tmp.name if own else workdir
    try:
        os.makedirs(workdir, exist_ok=True)
        job = dict(target=target, payload=payload, backend=backend, device=device,
                   timeout=timeout)
        with open(os.path.join(workdir, "job.pkl"), "wb") as f:
            pickle.dump(job, f)
        env = dict(os.environ, WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
                   JAX_COORDINATOR_ADDRESS="file://" + os.path.join(workdir, "rendezvous"),
                   PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs, logs = [], []
        for r in range(world):
            log = open(os.path.join(workdir, f"rank{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "stratanet2_tpu_torch.parallel.launch", workdir, str(r)],
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=log,
                stderr=subprocess.STDOUT, cwd=_REPO))
        deadline = time.monotonic() + timeout
        failed = None
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
            if bad or time.monotonic() > deadline:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}" if bad \
                    else f"timed out after {timeout:.0f} s"
                break
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
        if failed is None and any(p.returncode for p in procs):
            bad = [r for r, p in enumerate(procs) if p.returncode]
            failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
        if failed is not None:
            tails = []
            for r in range(world):
                with open(os.path.join(workdir, f"rank{r}.log")) as f:
                    tails.append(f"--- rank {r} ---\n" + f.read()[-4000:])
            raise RuntimeError(f"run_ranks({world}, {target}): {failed}\n" + "\n".join(tails))
        out = []
        for r in range(world):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        if tmp is not None:
            tmp.cleanup()


def _rank_main(workdir: str, rank: int) -> int:
    import torch

    from stratanet2_tpu_torch.parallel import multihost

    with open(os.path.join(workdir, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    torch.set_num_threads(1)
    try:
        multihost.initialize(backend=job["backend"], timeout=job["timeout"])
        device = multihost.rank_device(job["device"])
        if device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)  # the object collectives of nccl run there
        module, name = job["target"].split(":")
        result = getattr(importlib.import_module(module), name)(job["payload"], device)
        with open(os.path.join(workdir, f"rank{rank}.pkl.tmp"), "wb") as f:
            pickle.dump(result, f)
        os.replace(os.path.join(workdir, f"rank{rank}.pkl.tmp"),
                   os.path.join(workdir, f"rank{rank}.pkl"))
    except Exception:  # the process boundary: report, exit non-zero
        traceback.print_exc()
        sys.stdout.flush()
        return 1
    multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1], int(sys.argv[2])))
