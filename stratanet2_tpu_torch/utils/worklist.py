"""Idempotent file worklists for parcel-scale runs (a copy of
`stratanet2_tpu/utils/worklist.py`).

The reference distributes parcel work across independent processes by
diffing input files against produced outputs (utils/utils.py:118-134,
prepare.py:48-59, predict.py:80-89); restarted jobs skip finished parcels —
the implicit failure-recovery mechanism (SURVEY.md §5). Kept here, extended
with deterministic host-sharding for multi-host fleets.
"""

from __future__ import annotations

import glob
import os
import random
import zlib
from typing import List, Optional


def stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def files_in(folder: str) -> List[str]:
    return [p for p in glob.glob(os.path.join(folder, "*")) if os.path.isfile(p)]


def host_shard_of(path: str, n_hosts: int) -> int:
    """Owning host of a worklist entry: stable hash of the STEM (crc32 —
    the built-in hash() is salted per interpreter and would partition
    differently on every host)."""
    return zlib.crc32(stem(path).encode()) % n_hosts


def get_unprocessed_files(
    input_folder: str,
    output_folder: str,
    host_id: int = 0,
    n_hosts: int = 1,
    shuffle_seed: Optional[int] = None,
) -> List[str]:
    """Input files with no same-stem output yet, optionally sharded by host
    (stable hash of the stem) and shuffled to reduce collision odds between
    concurrent unsharded workers (prepare.py:58)."""
    done = {stem(p) for p in files_in(output_folder)} if os.path.isdir(output_folder) else set()
    todo = [p for p in files_in(input_folder) if stem(p) not in done]
    if n_hosts > 1:
        todo = [p for p in todo if host_shard_of(p, n_hosts) == host_id]
    rnd = random.Random(shuffle_seed)
    rnd.shuffle(todo)
    return todo
