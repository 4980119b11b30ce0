"""Clip dataset + batched loader (counterpart of agrl_tpu/data/loader.py).

`ImageDataset` holds image re-id records, items (H, W, 3) uint8, pid,
camid, with no adjacency.

Item contract (parity with dataset_loader.py:83-215): imgs (S, H, W, 3)
uint8, pid, camid, adj (V, V) float32; enable_pose=False -> all-ones
adjacency. All seven clip strategies of agrl_tpu: `evenly`, `dense`,
`skipdense` and `all` (eval) and `random`, `consecutive`, `restricted`
(train), each from a per-item numpy RandomState that the loader seeds as
agrl_tpu's does, so items are bit-equal to agrl_tpu's for the same seed.
A `dense`/`skipdense` item is the tracklet's n clips, imgs (n, S, H, W, 3)
and adjs (n, V, V); an `all` item is the whole tracklet (truncated at
max_len), imgs (num, H, W, 3) and adj (num * parts, num * parts). Those
vary in length, so their loaders take batches of one.

Host input as agrl_tpu's: frames decode natively or with PIL
(`transforms.host_decode_resize`), through an optional byte-capped RAM
cache and a persistent frame store (`data/cache.py`); deterministic
loaders cache whole collated batches; `prefetch_to_device` builds the next
batches on a thread and copies them to the card behind the step.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from agrl_torch.data.cache import BoundedCache, FrameDiskCache
from agrl_torch.data.graph import GraphBuilder
from agrl_torch.data.pose import pose_key_for_path
from agrl_torch.data.sampling import SAMPLE_METHODS, sample_clip_indices
from agrl_torch.data.transforms import effective_decoder, host_decode_resize

# strategies that draw nothing from the item's rng: their items (and the
# loader's collated batches) are the same every epoch
DETERMINISTIC_SAMPLES = ("evenly", "all", "dense", "skipdense")


class ImageDataset:
    """Image re-id items (agrl_tpu/data/loader.py:32-49; the reference's
    dataset_loader.py:39-55): (img (H, W, 3) uint8, pid, camid) a record,
    decoded and resized on the host. They carry no adjacency, so a
    ClipLoader over them collates an all-ones (B, 1, 1) one. `decode` as
    VideoClipDataset's."""

    def __init__(self, dataset: list, height: int = 256, width: int = 128,
                 decode: str = "pil"):
        self.dataset = dataset
        self.height = height
        self.width = width
        self.decode = decode

    def __len__(self):
        return len(self.dataset)

    def get_item(self, index: int, rng=None):
        img_path, pid, camid = self.dataset[index]
        imgs, _ = host_decode_resize([img_path], self.height, self.width, decode=self.decode)
        return imgs[0], pid, camid


class VideoClipDataset:
    """Host-side per-tracklet item assembly.

    `cache_frames` / `cache` / `cache_bytes`: one byte-capped LRU
    (`BoundedCache`; pass a shared `cache` so several datasets draw from
    one budget) holds decoded frames (key: image path) and, for the
    deterministic strategies, whole items (key: (tag, index)), so repeat
    epochs skip decode, graph build and stacking. `disk_cache`: a
    `FrameDiskCache` or its directory, consulted after the RAM cache.
    `decode`: "auto", "native" or "pil" (`transforms.host_decode_resize`);
    the default here is "pil", the reference's pixels, and the CLI passes
    its `--decode` (default auto). `decode_threads`: the native decoder's
    OpenMP width, None = resolved by the ClipLoader."""

    _instance_counter = 0
    _counter_lock = threading.Lock()

    def __init__(
        self,
        tracklets: list,
        seq_len: int = 8,
        sample: str = "evenly",
        height: int = 256,
        width: int = 128,
        pose_info: dict | None = None,
        num_split: int = 4,
        num_parts: int = 3,
        num_scale: int = 1,
        pyramid_part: bool = True,
        enable_pose: bool = True,
        max_len: int = 1000,
        cache_frames: bool = False,
        cache: BoundedCache | None = None,
        cache_bytes: int | None = None,
        disk_cache: FrameDiskCache | str | None = None,
        decode_threads: int | None = None,
        decode: str = "pil",
    ):
        if sample not in SAMPLE_METHODS:
            raise KeyError(f"Unknown sample method: {sample}. Expected one of {SAMPLE_METHODS}")
        self.tracklets = tracklets
        self.seq_len = seq_len
        self.sample = sample
        self.height = height
        self.width = width
        self.pose_info = pose_info if pose_info is not None else {}
        self.max_len = max_len
        if cache is None and cache_frames:
            cache = BoundedCache(cache_bytes)
        self.cache = cache
        self.cache_items = sample in DETERMINISTIC_SAMPLES
        # a tag that is never reused, not id(self): CPython reuses addresses,
        # so a new dataset could read a dead one's items out of a shared cache
        with VideoClipDataset._counter_lock:
            VideoClipDataset._instance_counter += 1
            self.item_tag = f"item:{VideoClipDataset._instance_counter}"
        if isinstance(disk_cache, str):
            disk_cache = FrameDiskCache(disk_cache, height, width,
                                        decoder=effective_decoder(decode))
        self.disk_cache = disk_cache
        self.decode_threads = decode_threads
        self.decode_mode = decode
        self.graph_builder = GraphBuilder(
            num_split=num_split,
            num_parts=num_parts,
            num_scale=num_scale,
            pyramid_part=pyramid_part,
            enable_pose=enable_pose,
        )

    def __len__(self):
        return len(self.tracklets)

    @property
    def num_vertices(self):
        return self.graph_builder.num_vertices(self.seq_len)

    def decode(self, paths):
        """(len(paths), H, W, 3) uint8 frames and their source sizes,
        through the caches. Whole items cached -> no frame-cache copy too
        (it would hold a second decoded copy of every frame for no reuse)."""
        return host_decode_resize(
            paths, self.height, self.width,
            cache=None if self.cache_items else self.cache,
            disk_cache=self.disk_cache,
            threads=1 if self.decode_threads is None else self.decode_threads,
            decode=self.decode_mode,
        )

    def _clip_adj(self, paths, sizes):
        if not self.graph_builder.enable_pose:
            # sized by the clip's length: an `all` item carries the whole tracklet
            return self.graph_builder.ones(len(paths))
        keys = []
        for p in paths:
            try:
                keys.append(pose_key_for_path(p))
            except ValueError:
                keys.append(None)  # unparseable path -> empty part sets
        # missing/malformed poses degrade per frame (reference fallback,
        # dataset_loader.py:332-333) — from_pose_dict owns that contract
        return self.graph_builder.from_pose_dict(keys, sizes, self.pose_info)

    def get_item(self, index: int, rng: np.random.RandomState | None = None):
        if self.cache is not None and self.cache_items:
            key = (self.item_tag, index)
            hit = self.cache.get(key)
            if hit is not None:
                return hit
            item = self._build_item(index, rng)
            self.cache[key] = item
            return item
        return self._build_item(index, rng)

    def peek_or_build(self, index: int, rng=None):
        """get_item without the item-cache WRITE: reuses an existing item
        entry but stores none — the ClipLoader's batch cache holds the same
        bytes collated, and a second copy would double the budget."""
        if self.cache is not None and self.cache_items:
            hit = self.cache.get((self.item_tag, index))
            if hit is not None:
                return hit
        return self._build_item(index, rng)

    def _build_item(self, index: int, rng: np.random.RandomState | None = None):
        img_paths, pid, camid = self.tracklets[index]
        num = min(len(img_paths), self.max_len)
        indices = sample_clip_indices(num, self.seq_len, self.sample, rng, self.max_len)
        chosen = [img_paths[int(i)] for i in indices]
        imgs, sizes = self.decode(chosen)
        if self.sample in ("dense", "skipdense"):
            n, S = len(indices) // self.seq_len, self.seq_len
            imgs = imgs.reshape(n, S, *imgs.shape[1:])
            adjs = np.stack([
                self._clip_adj(chosen[i * S:(i + 1) * S], sizes[i * S:(i + 1) * S])
                for i in range(n)
            ])
            return imgs, pid, camid, adjs
        return imgs, pid, camid, self._clip_adj(chosen, sizes)


class ClipLoader:
    """Batched iterator over a VideoClipDataset, yielding (imgs_u8
    (B, S, H, W, 3), pids (B,), camids (B,), adjs (B, V, V)).

    `sampler` yields dataset indices (e.g. RandomIdentitySamplerV1); when
    None, the dataset is read in order. The last batch may be short unless
    `drop_last`. Each item gets its own RandomState, seeded from the
    loader's `seed` stream per batch and drawn for every batch before the
    first is built, as agrl_tpu/data/loader.py:292-297 draws them.
    `num_workers` > 1 builds the items of a batch on a thread pool (PIL
    and the native decoder release the interpreter lock); the native
    decoder then decodes on one thread per call, and with one worker on
    the hardware's width (agrl_tpu :251-252).

    A loader with no sampler over a dataset with a cache and a
    deterministic strategy caches each COLLATED batch, keyed by its member
    indices: a warm epoch is one LRU lookup per batch. Cached batches are
    yielded by reference; consumers treat loader output as read-only.

    `malloc_tuning=True` applies utils.hostmem.tune_malloc_for_streaming, a
    process-wide glibc policy (batch buffers reuse warm heap pages); the
    CLI opts in.

    `process_shard=(rank, world)`: data-parallel loading (agrl_tpu/data/
    loader.py:221-310). Every rank runs the identically seeded sampler and
    draws the per-item seeds of the GLOBAL batch before slicing, so an item
    gets the seed a one-process run gives it; each rank builds only its
    contiguous batch_size / world slice of every batch. A ragged tail keeps
    len // world items a rank, and a tail shorter than world yields
    nothing (agrl_tpu's `__len__`). The eval loaders are not sharded: every
    rank reads the whole query and gallery."""

    def __init__(
        self,
        dataset: VideoClipDataset,
        batch_size: int,
        sampler=None,
        drop_last: bool = False,
        num_workers: int = 1,
        seed: int | None = None,
        malloc_tuning: bool = False,
        process_shard: tuple[int, int] | None = None,
    ):
        if malloc_tuning:
            from agrl_torch.utils.hostmem import tune_malloc_for_streaming

            tune_malloc_for_streaming()
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        if getattr(dataset, "decode_threads", 1) is None:
            dataset.decode_threads = 0 if self.num_workers == 1 else 1
        self.rng = np.random.RandomState(seed)
        if process_shard is not None:
            rank, world = process_shard
            if not 0 <= rank < world:
                raise ValueError(f"process_shard rank {rank} is not in [0, {world})")
            if batch_size % world:
                raise ValueError(f"batch {batch_size} does not divide over {world} processes")
        self.process_shard = process_shard

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        rem = n % self.batch_size
        if rem and self.process_shard is not None and rem < self.process_shard[1]:
            return n // self.batch_size  # a tail shorter than the world yields nothing
        return -(-n // self.batch_size)

    @property
    def batch_cacheable(self) -> bool:
        return (self.sampler is None and getattr(self.dataset, "cache", None) is not None
                and getattr(self.dataset, "cache_items", False))

    def __iter__(self):
        if self.sampler is not None:
            indices = list(iter(self.sampler))
        else:
            indices = list(range(len(self.dataset)))
        stop = len(indices) - len(indices) % self.batch_size if self.drop_last else len(indices)
        batches = [indices[i:i + self.batch_size] for i in range(0, stop, self.batch_size)]
        seeded = [(b, self.rng.randint(0, 2**31 - 1, size=len(b))) for b in batches]
        if self.process_shard is not None:  # this rank's slice of each global batch
            rank, world = self.process_shard
            seeded = [(b[rank * k:(rank + 1) * k], s[rank * k:(rank + 1) * k])
                      for b, s in seeded for k in [len(b) // world] if k]
        cacheable = self.batch_cacheable
        cache = self.dataset.cache if cacheable else None

        pool = ThreadPoolExecutor(self.num_workers) if self.num_workers > 1 else None
        try:
            for batch_idxs, seeds in seeded:
                if cacheable:
                    key = (self.dataset.item_tag, "batch", tuple(batch_idxs))
                    hit = cache.get(key)
                    if hit is not None:
                        yield hit
                        continue
                    build = self.dataset.peek_or_build  # the batch holds the bytes
                else:
                    build = self.dataset.get_item
                pairs = [(i, np.random.RandomState(s)) for i, s in zip(batch_idxs, seeds)]
                if pool is None:
                    items = [build(*a) for a in pairs]
                else:
                    items = list(pool.map(lambda a: build(*a), pairs))
                batch = self._collate(items)
                if cacheable:
                    cache[key] = batch
                yield batch
        finally:
            if pool is not None:
                # cancel queued work, then WAIT for in-flight builds: a
                # consumer that abandons the generator may close the
                # dataset's FrameDiskCache next, under a worker's pread
                pool.shutdown(wait=True, cancel_futures=True)

    @staticmethod
    def _collate(items):
        imgs = np.stack([it[0] for it in items])
        pids = np.asarray([it[1] for it in items], dtype=np.int32)
        camids = np.asarray([it[2] for it in items], dtype=np.int32)
        if len(items[0]) < 4:  # ImageDataset items carry no adjacency
            adjs = np.ones((len(items), 1, 1), dtype=np.float32)
        else:
            adjs = np.stack([it[3] for it in items]).astype(np.float32)
        return imgs, pids, camids, adjs


_DONE = object()


def prefetch_to_device(iterator, size: int = 2, device="cuda"):
    """Yields the batches (tuples of numpy arrays) of `iterator`, built up
    to `size` ahead on a background thread (agrl_tpu/data/loader.py:383-413
    overlaps them with JAX's asynchronous dispatch; a torch step holds the
    host, so the batches are built beside it instead). A data-parallel rank
    passes its own card: each rank's slice goes to its device.

    On a CUDA `device` each batch is copied into pinned buffers of its own
    (never the iterator's arrays, which may be a cache's) and to the card
    on a side stream; the consumer's stream waits on that copy's event and
    the device tensors get `record_stream`, so they are safe to use on it.
    A tuple of device tensors is yielded. On the CPU the batches pass
    through unchanged: the thread alone.

    An exception in the thread re-raises in the consumer. Closing the
    generator early (or an error in the consumer) stops the thread and
    joins it, which closes `iterator` — a ClipLoader then shuts its pool
    down after its in-flight builds."""
    from agrl_torch import resolve_device

    device = resolve_device(device)
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def stage(batch):
        if not cuda:
            return batch, None
        pinned = [torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                              pin_memory=True) for a in batch]
        for buf, a in zip(pinned, batch):
            buf.numpy()[...] = a
        with torch.cuda.stream(side):
            out = tuple(buf.to(device, non_blocking=True) for buf in pinned)
            event = torch.cuda.Event()
            event.record(side)
        return out, (event, pinned)

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        it = iter(iterator)
        try:
            for batch in it:
                if not put(stage(batch)):
                    break
            else:
                put((_DONE, None))
        except Exception as e:  # handed to the consumer, which re-raises it
            put((e, None))
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    worker = threading.Thread(target=produce, name="prefetch", daemon=True)
    worker.start()
    try:
        while True:
            item, sync = q.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            if sync is not None:
                event, _pinned = sync
                stream = torch.cuda.current_stream(device)
                stream.wait_event(event)
                for t in item:
                    t.record_stream(stream)
            yield item
    finally:
        stop.set()
        worker.join()
