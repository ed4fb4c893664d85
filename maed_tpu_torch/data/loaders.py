"""Host-sharded batching loaders (a DistributedSampler + DataLoader).

Port of ``maed_tpu/data/loaders.py`` (the original MAED's
``lib/dataset/loaders.py`` with DistributedSampler semantics: a per-host
shard, an epoch-seeded reshuffle, padding to equal length across hosts).
A plain-Python iterator with worker processes or a background prefetch
thread; batch contents are a pure function of (seed, epoch, index). Worker
processes fork while the parent holds no CUDA context, and start from a
forkserver once it does (torch's, or the nvJPEG decoder's).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional, Sequence

import numpy as np


class ConcatDataset:
    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self.cum[-1]) if len(self.datasets) else 0

    def __getitem__(self, index, rng=None):
        ds_idx = int(np.searchsorted(self.cum, index, side="right"))
        base = 0 if ds_idx == 0 else int(self.cum[ds_idx - 1])
        return self.datasets[ds_idx].__getitem__(index - base, rng=rng)


def collate(samples):
    """Stack a list of sample dicts into a batch dict (numpy)."""
    out = {}
    if "trans" in samples[0]:
        # DEVICE_CROP: the samples' raw frames stack into one device array
        sizes = {s["images"].shape[-3:] for s in samples}
        if len(sizes) != 1:
            raise ValueError(f"DEVICE_CROP needs uniform source frame sizes within a batch, "
                             f"got {sorted(sizes)}; use DEVICE_PREPROC (host uint8 crop) for "
                             "mixed-size sources")
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], (str, bytes)) or (
            isinstance(vals[0], list) and vals[0] and isinstance(vals[0][0], str)
        ):
            out[k] = vals  # strings / lists of strings (paths, instance ids)
        elif isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]) or isinstance(vals[0], np.generic):
            out[k] = np.stack(vals, axis=0)
        else:
            out[k] = vals
    return out


def _default_start_method() -> str:
    """'fork' while the parent holds no CUDA context (workers inherit the
    in-memory DB copy-on-write instead of pickling it); 'forkserver' once
    torch or the native nvJPEG decoder made one in this process: a forked
    child of a process with a live CUDA context cannot use CUDA, and may
    deadlock on an inherited lock. MAED_LOADER_MP overrides either way."""
    import sys

    from maed_tpu_torch import native

    torch_mod = sys.modules.get("torch")
    cuda_live = torch_mod is not None and torch_mod.cuda.is_initialized()
    return "forkserver" if cuda_live or native.device_live() else "fork"


def _worker_main(loader, idxs, out_q, consumed, worker_id, nb, nw, window,
                 epoch, start):
    """Loader worker body (module-level so spawn/forkserver contexts can
    pickle it). Produces batches b = worker_id, worker_id+nw, ... pausing
    whenever it runs more than `window` batches ahead of the consumer.
    epoch/start arrive as explicit arguments (not read off the pickled
    loader) so every path binds them identically at iteration start.

    SIGTERM is reset to its default first: a forked worker inherits the
    parent's handlers (the trainer's preemption handler only sets a flag),
    and the consumer's terminate() must end it."""
    import signal
    import time as _time

    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    try:
        for b in range(worker_id, nb, nw):
            if b < start:
                continue
            while b - consumed.value > window:
                _time.sleep(0.005)
            batch = loader._make_batch(idxs, b, epoch)
            if batch is None:
                break
            out_q.put((b, batch))
        out_q.put((None, worker_id))
    except BaseException as e:
        out_q.put((-1, f"{type(e).__name__}: {e}"))


class ShardedLoader:
    """Iterates a dataset in batches over this host's shard of the indices.

    shuffle=True draws a new permutation per epoch from seed+epoch (call
    set_epoch like the reference trainer does). Equal-length shards are
    guaranteed by padding with wrapped-around indices, so every host runs the
    same number of steps (collective-friendly); ``pad=False`` leaves the
    shards unpadded (r of W takes indices r, r + W, ...: each index once),
    for an evaluation whose ranks meet only at the end.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        rank: int = 0,
        world_size: int = 1,
        seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 2,
        num_workers: int = 0,
        pad: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rank = rank
        self.world_size = world_size
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.pad = pad

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _shard_indices(self, epoch: Optional[int] = None):
        n = len(self.dataset)
        if epoch is None:
            epoch = self.epoch
        if self.shuffle:
            g = np.random.RandomState(self.seed + epoch)
            order = g.permutation(n)
        else:
            order = np.arange(n)
        # pad so each of the world_size shards has equal length
        total = int(np.ceil(n / self.world_size)) * self.world_size
        if total > n and self.pad:
            order = np.concatenate([order, order[: total - n]])
        return order[self.rank::self.world_size]

    def __len__(self):
        per_shard = int(np.ceil(len(self.dataset) / self.world_size))
        if not self.pad:
            per_shard = len(range(self.rank, len(self.dataset), self.world_size))
        if self.drop_last:
            return per_shard // self.batch_size
        return int(np.ceil(per_shard / self.batch_size))

    def _make_batch(self, idxs, b, epoch: Optional[int] = None):
        if epoch is None:
            epoch = self.epoch
        chunk = idxs[b * self.batch_size:(b + 1) * self.batch_size]
        if len(chunk) < self.batch_size and self.drop_last:
            return None
        samples = []
        for i in chunk:
            # per-(epoch, index) rng: augmentation draws are deterministic
            # and identical no matter which worker fetches the sample
            rng = np.random.RandomState(
                (self.seed + epoch * 1_000_003 + int(i)) % (2 ** 31 - 1)
            )
            samples.append(self.dataset.__getitem__(int(i), rng=rng))
        return collate(samples)

    def _batches(self, epoch: int, start: int = 0):
        idxs = self._shard_indices(epoch)
        for b in range(start, len(self)):
            batch = self._make_batch(idxs, b, epoch)
            if batch is None:
                return
            yield batch

    def _iter_workers(self, epoch: int, start: int = 0,
                      stall_timeout: float = 600.0):
        """Multi-process fetch: worker w produces batches b with
        b % num_workers == w (torch DataLoader's round-robin assignment, as
        the original MAED's loaders take NUM_WORKERS);
        the consumer reorders so batch order is identical to num_workers=0.
        Start method: see _default_start_method — fork (DB inherited
        copy-on-write) while the parent holds no CUDA context, forkserver
        once it does; MAED_LOADER_MP overrides.

        A shared progress counter caps worker lookahead at 2*num_workers
        batches past the consumer, so one slow worker cannot make the
        reorder buffer grow without bound; a consumer watchdog raises after
        `stall_timeout` seconds without progress (a forked child deadlocked
        on an inherited lock presents as alive-but-silent)."""
        import multiprocessing as mp
        import os
        import time as _time

        ctx = mp.get_context(os.environ.get("MAED_LOADER_MP") or
                             _default_start_method())
        nb = len(self)
        nw = min(self.num_workers, max(nb, 1))
        out_q = ctx.Queue(maxsize=max(2 * nw, 4))
        consumed = ctx.Value("l", start)  # next_b, visible to workers
        idxs = self._shard_indices(epoch)
        window = 2 * nw

        procs = [
            ctx.Process(
                target=_worker_main,
                args=(self, idxs, out_q, consumed, w, nb, nw, window,
                      epoch, start),
                daemon=True,
            )
            for w in range(nw)
        ]
        for p in procs:
            p.start()
        try:
            pending = {}
            done_workers = 0
            next_b = start
            last_progress = _time.monotonic()
            while done_workers < nw or pending:
                if next_b in pending:
                    yield pending.pop(next_b)
                    next_b += 1
                    with consumed.get_lock():
                        consumed.value = next_b
                    last_progress = _time.monotonic()
                    continue
                if done_workers == nw:
                    break  # remaining batches were dropped (drop_last)
                try:
                    b, payload = out_q.get(timeout=30)
                except queue.Empty:
                    if not any(p.is_alive() for p in procs):
                        raise RuntimeError(
                            "all loader workers died without a sentinel "
                            "(killed? OOM?)"
                        )
                    if _time.monotonic() - last_progress > stall_timeout:
                        raise RuntimeError(
                            f"loader stalled: no batch for {stall_timeout:.0f}s "
                            f"while waiting for batch {next_b} (a worker may "
                            "have deadlocked after fork — try "
                            "MAED_LOADER_MP=forkserver)"
                        )
                    continue
                last_progress = _time.monotonic()
                if b is None:
                    done_workers += 1
                elif b == -1:
                    raise RuntimeError(f"loader worker failed: {payload}")
                else:
                    pending[b] = payload
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.join(timeout=5)

    def __iter__(self):
        return self.iter_from(self.epoch)

    def iter_from(self, epoch: int, start: int = 0):
        """Iterate this epoch's batch sequence starting at batch `start`.

        Batch content is a pure function of (epoch, batch index): the
        permutation comes from seed+epoch and each sample's augmentation RNG
        from (seed, epoch, dataset index) — so iter_from(e, k) reproduces the
        tail of an uninterrupted epoch-e iteration bit-exactly. This is the
        preemption-resume primitive (trainer emergency checkpoints record
        (epoch, position); resume skips the already-trained prefix without
        re-decoding it) and also pins (epoch, start) EAGERLY: previously the
        thread-prefetch path read self.epoch per batch while worker
        processes snapshotted it at fork, so a mid-iteration set_epoch
        changed augmentation draws on one path and not the other."""
        epoch, start = int(epoch), int(start)
        if self.num_workers > 0:
            return self._iter_workers(epoch, start)
        if self.prefetch <= 0:
            return self._batches(epoch, start)
        return self._prefetch_thread(epoch, start)

    def _prefetch_thread(self, epoch: int, start: int):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err = []

        def worker():
            try:
                for batch in self._batches(epoch, start):
                    q.put(batch)
            except BaseException as e:  # surface loader errors in the consumer
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item


class InfiniteLoader:
    """Cycles a ShardedLoader forever (the original MAED trainer's
    StopIteration -> set_epoch -> re-iter pattern).

    The shuffle epoch is a single monotone counter owned here: the trainer
    drives it forward at each outer epoch via set_epoch, and a mid-epoch wrap
    bumps it past the last value. Deliberate deviation from the reference
    (which re-seeds a wrap with the unchanged trainer epoch, repeating the
    same sample order): a permutation — and the per-(epoch, index)
    augmentation RNG seeded from it — is never reused.
    """

    def __init__(self, loader: ShardedLoader):
        self.loader = loader
        self.epoch = 0
        self.iter_epoch = 0  # epoch the LIVE iterator was seeded with (may
        #                      trail self.epoch when set_epoch lands mid-wrap)
        self.pos = 0         # batches consumed from the live iterator
        self._it = self._new_iter()

    def _new_iter(self, start: int = 0):
        self.iter_epoch = self.epoch
        self.pos = start
        self.loader.set_epoch(self.epoch)
        if hasattr(self.loader, "iter_from"):
            return self.loader.iter_from(self.epoch, start)
        if start:
            raise ValueError(
                f"loader {type(self.loader).__name__} has no iter_from; "
                "mid-epoch restore needs a ShardedLoader")
        return iter(self.loader)

    def set_epoch(self, epoch: int):
        """Trainer hook: advance the shuffle epoch (never backwards, so a
        loader that wrapped ahead mid-epoch keeps fresh permutations). If the
        live iterator is still unconsumed (fresh construction, epoch-level
        resume), it is re-seeded at the new epoch; once consumption started,
        the in-flight permutation keeps its original seed until it wraps
        (iter_from binds (epoch, start) eagerly on every path — previously
        the thread path re-read the epoch per batch while process workers
        snapshotted it, so the same mid-iteration set_epoch produced
        different augmentation draws depending on NUM_WORKERS)."""
        new = max(int(epoch), self.epoch)
        if new != self.epoch:
            self.epoch = new
            if self.pos == 0:
                self._it = self._new_iter()
        self.loader.set_epoch(self.epoch)

    def state(self) -> dict:
        """Exact position for preemption checkpoints (see restore)."""
        return {"epoch": self.epoch, "iter_epoch": self.iter_epoch,
                "pos": self.pos}

    def restore(self, st: dict):
        """Reposition exactly where state() was captured: the live iterator
        is rebuilt at (iter_epoch, pos) — batch content is a pure function
        of those two (ShardedLoader.iter_from) — and the monotone shuffle
        counter resumes at the recorded epoch."""
        self.epoch = int(st["epoch"])
        self.iter_epoch = int(st["iter_epoch"])
        self.pos = int(st["pos"])
        if not hasattr(self.loader, "iter_from"):
            raise ValueError(
                f"loader {type(self.loader).__name__} has no iter_from; "
                "mid-epoch restore needs a ShardedLoader")
        self.loader.set_epoch(self.epoch)
        self._it = self.loader.iter_from(self.iter_epoch, self.pos)

    def __next__(self):
        try:
            batch = next(self._it)
        except StopIteration:
            self.epoch += 1
            self._it = self._new_iter()
            batch = next(self._it)
        self.pos += 1
        return batch


def get_data_loaders(
    cfg,
    rank: int = 0,
    world_size: int = 1,
    db_overrides: Optional[dict] = None,
    verbose: bool = True,
):
    """Build train-2D / train-3D / train-img / valid loaders per the config.

    db_overrides maps dataset name -> preloaded DB dict (used by tests and
    environments without the preprocessed DB files).
    """
    import os

    from maed_tpu_torch.data.dataset import ImageDataset, VideoDataset
    from maed_tpu_torch.data.transforms import build_eval_transforms, build_train_transforms

    d = cfg.DATASET
    # color jitter applies ONLY to the 3D video pipeline; the 2D and image
    # stacks are crop/erase/flip only (the original MAED's train.py:40-63)
    train_tf_3d = build_train_transforms(d, color_jitter=True)
    train_tf = build_train_transforms(d, color_jitter=False)
    eval_tf = build_eval_transforms(
        d.WIDTH, d.HEIGHT,
        device_normalize=bool(getattr(d, "DEVICE_PREPROC", False)),
        device_crop=bool(getattr(d, "DEVICE_CROP", False)))
    db_overrides = db_overrides or {}
    # worker processes (reference DataLoader NUM_WORKERS) only help with
    # spare cores; on a 1-core host fall back to the prefetch thread
    workers = min(int(getattr(cfg, "NUM_WORKERS", 0)),
                  max((os.cpu_count() or 1) - 1, 0))

    def vds(name, set_name, tf=None, **kw):
        return VideoDataset(
            name, set_name,
            tf if tf is not None else (train_tf if set_name == "train" else eval_tf),
            db=db_overrides.get(name), verbose=verbose, **kw,
        )

    loaders = {}

    if cfg.TRAIN.DATASETS_2D:
        ds2d = ConcatDataset([
            vds(n, "train", seqlen=d.SEQLEN, sample_pool=d.SAMPLE_POOL,
                overlap=d.OVERLAP, random_sample=d.RANDOM_SAMPLE,
                random_start=d.RANDOM_START)
            for n in cfg.TRAIN.DATASETS_2D
        ])
        loaders["train_2d"] = ShardedLoader(
            ds2d, cfg.TRAIN.BATCH_SIZE_2D, shuffle=True, rank=rank,
            world_size=world_size, seed=cfg.SEED_VALUE if cfg.SEED_VALUE > 0 else 0,
            num_workers=workers,
        )

    if cfg.TRAIN.DATASETS_3D:
        ds3d = ConcatDataset([
            vds(n, "train", tf=train_tf_3d, seqlen=d.SEQLEN,
                sample_pool=d.SAMPLE_POOL,
                overlap=8 if n == "3dpw" else d.OVERLAP,
                random_sample=d.RANDOM_SAMPLE, random_start=d.RANDOM_START)
            for n in cfg.TRAIN.DATASETS_3D
        ])
        loaders["train_3d"] = ShardedLoader(
            ds3d, cfg.TRAIN.BATCH_SIZE_3D, shuffle=True, rank=rank,
            world_size=world_size, seed=1 + (cfg.SEED_VALUE if cfg.SEED_VALUE > 0 else 0),
            num_workers=workers,
        )

    if cfg.TRAIN.DATASETS_IMG:
        dsimg = ConcatDataset([
            ImageDataset(n, "train", train_tf, db=db_overrides.get(n),
                         verbose=verbose, subsample=5 if n == "mpii3d" else 1)
            for n in cfg.TRAIN.DATASETS_IMG
        ])
        loaders["train_img"] = ShardedLoader(
            dsimg, cfg.TRAIN.BATCH_SIZE_IMG, shuffle=True, rank=rank,
            world_size=world_size, seed=2 + (cfg.SEED_VALUE if cfg.SEED_VALUE > 0 else 0),
            num_workers=workers,
        )

    eval_name = cfg.TRAIN.DATASET_EVAL.lower().replace("threedpw", "3dpw")
    loaders["valid"] = ShardedLoader(
        VideoDataset(
            # seqlen=0: the loader yields FULL sample_pool windows; the
            # Evaluator slices them into EVAL.SEQLEN clips itself.
            eval_name, "val", eval_tf, seqlen=0,
            sample_pool=cfg.EVAL.SAMPLE_POOL, overlap=0,
            random_sample=False, random_start=False,
            db=db_overrides.get(eval_name + "_val"), verbose=verbose,
        ),
        cfg.EVAL.BATCH_SIZE, shuffle=False, rank=rank, world_size=world_size,
        drop_last=False,
    )
    return loaders
