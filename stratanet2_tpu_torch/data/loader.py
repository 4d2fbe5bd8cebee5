"""Host batch pipeline: fixed-shape device batches with background prefetch
(a copy of `stratanet2_tpu/data/loader.py`: the same seeds give the same
batches bit for bit).

Replaces the reference's torch DataLoader + torchnet ListDataset
(data_loader/loader.py:10-43, learning/train.py:33-38) with a thread-pooled
producer of static-shape numpy batches (the shapes XLA compiled for), double-
buffered ahead of the device (SURVEY.md §2.4 'multi-worker input pipeline').
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from stratanet2_tpu_torch.config import Config
from stratanet2_tpu_torch.data.dataset import get_index_sorted_plot_ids
from stratanet2_tpu_torch.data.transforms import load_cloud_item


class PlotLoader:
    """Iterates fixed-shape batches over a plot dataset.

    Train mode: shuffled, drop_last (learning/train.py:33-38).
    Eval/inference mode: ordered, final partial batch padded by repeating the
    last item (padding flagged in `batch["valid"]` so metrics ignore it) —
    static shapes keep a single compiled executable.

    `rows` (a slice of the batch) builds only those rows of every batch,
    each as the whole batch's: a data-parallel rank loads its share alone
    (each plot's augmentation draws from a generator of its own, seeded
    from the epoch's shuffle).
    """

    def __init__(
        self,
        dataset: Dict,
        cfg: Config,
        plot_ids: Optional[Sequence[str]] = None,
        train: bool = False,
        batch_size: Optional[int] = None,
        seed: int = 0,
        workers: Optional[int] = None,
        rows: Optional[slice] = None,
    ):
        self.dataset = dataset
        self.cfg = cfg
        self.train = train
        self.batch_size = batch_size or cfg.train.batch_size
        self.plot_ids = (
            np.asarray(plot_ids)
            if plot_ids is not None
            else get_index_sorted_plot_ids(dataset)
        )
        self.seed = seed
        self.epoch = 0
        self.workers = workers if workers is not None else cfg.data.loader_workers
        self.rows = rows

    def __len__(self) -> int:
        n = len(self.plot_ids)
        if self.train:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _item(self, plot_id: str, rng: np.random.Generator) -> Dict:
        return load_cloud_item(
            self.dataset[plot_id], self.cfg.model, self.train, rng
        )

    def _collate(self, items: List[Dict], n_valid: int) -> Dict:
        tdt = np.float16 if self.cfg.data.transfer_dtype == "float16" else np.float32
        batch = {
            "cloud": np.stack([it["cloud"] for it in items]).astype(tdt),
            "xyz": np.stack([it["xyz"] for it in items]).astype(tdt),
            "plot_id": [it["plot_id"] for it in items],
            "plot_center": np.stack([it["plot_center"] for it in items]),
            "valid": (np.arange(len(items)) < n_valid),
            "N_points_in_cloud": np.array(
                [it["N_points_in_cloud"] for it in items], np.int64
            ),
        }
        covs = [it["coverages"] for it in items]
        with_gt = sum(c.size == 4 for c in covs)
        if with_gt == len(covs):
            batch["coverages"] = np.stack(covs).astype(np.float32)
        elif with_gt:  # fail loudly NOW, naming the plots — silently
            # omitting the key would surface as a bare KeyError at a
            # shuffle-dependent step deep inside train_one_epoch
            bad = [it["plot_id"] for it in items if it["coverages"].size != 4]
            raise ValueError(
                f"batch mixes plots with and without 4-value coverages "
                f"(malformed GT for {bad[:5]})"
            )
        return batch

    def __iter__(self) -> Iterator[Dict]:
        ids = self.plot_ids.copy()
        rng = np.random.default_rng(self.seed + self.epoch)
        self.epoch += 1
        if self.train:
            rng.shuffle(ids)
            n_batches = len(ids) // self.batch_size
            ids = ids[: n_batches * self.batch_size]

        def batches():
            for i in range(0, len(ids), self.batch_size):
                chunk = list(ids[i : i + self.batch_size])
                n_valid = len(chunk)
                while len(chunk) < self.batch_size:  # eval-only padding
                    chunk.append(chunk[-1])
                yield chunk, n_valid

        item_rngs = {pid: np.random.default_rng(rng.integers(2**63)) for pid in ids}

        def make_batch(args):
            chunk, n_valid = args
            if self.rows is not None:
                start = self.rows.indices(len(chunk))[0]
                chunk, n_valid = chunk[self.rows], n_valid - start
            items = [self._item(pid, item_rngs[pid]) for pid in chunk]
            return self._collate(items, n_valid)

        if self.workers <= 0:
            for b in map(make_batch, batches()):
                yield b
            return

        # bounded-window submission: ThreadPoolExecutor.map would submit the
        # whole epoch eagerly and buffer every batch in memory; keep only
        # `workers + prefetch` batches in flight.
        window = self.workers + max(self.cfg.data.prefetch_batches, 1)
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            it = batches()
            pending = []
            for args in it:
                pending.append(pool.submit(make_batch, args))
                if len(pending) >= window:
                    yield pending.pop(0).result()
            for fut in pending:
                yield fut.result()


