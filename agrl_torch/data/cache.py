"""Host-side frame caches (counterpart of agrl_tpu/data/cache.py, whose
store layout it keeps byte for byte): a byte-capped LRU for RAM and a
persistent on-disk decoded-frame store.

The reference hides JPEG decode behind 8 torch DataLoader workers every
epoch (train_vidreid_xent_htri.py:37-38, reader dataset_loader.py:23-36)
and re-decodes the dataset each pass. Here decode is paid as rarely as
possible:

  * `BoundedCache` — the in-RAM frame/item/batch cache behind
    `--cache-frames`, with strict byte accounting and LRU eviction
    (`--cache-gb`). MARS at 256x128x3: ~510k distinct train frames, ~50 GB.
  * `FrameDiskCache` — an append-only uint8 record store keyed by image
    path (one store per (H, W)), layout version 3: a store written by
    agrl_tpu is read here and the reverse. The decode cost of a dataset is
    paid once per MACHINE, not once per run.

Both are thread-safe against the loader's decode thread pool.
"""

from __future__ import annotations

import os
import os.path as osp
import threading
from collections import OrderedDict

import numpy as np


def _nbytes(obj) -> int:
    """Approximate payload size of a cache value: summed ndarray bytes
    (+ a small fixed overhead for tuple/scalar structure)."""
    if isinstance(obj, np.ndarray):
        return obj.nbytes + 64
    if isinstance(obj, (tuple, list)):
        return sum(_nbytes(v) for v in obj) + 64
    return 64


class BoundedCache:
    """Byte-capped LRU mapping (thread-safe).

    `max_bytes=None` means unbounded. Access via
    `get`/`__setitem__`; `get` refreshes recency. When an insert pushes the
    total over the cap, least-recently-used entries are evicted until it
    fits; a single value larger than the whole cap is simply not stored.
    """

    def __init__(self, max_bytes: int | None = None):
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.max_bytes = max_bytes
        self.nbytes = 0
        self.evictions = 0

    def __len__(self):
        return len(self._d)

    def get(self, key, default=None):
        with self._lock:
            try:
                self._d.move_to_end(key)
                return self._d[key][0]
            except KeyError:
                return default

    def __setitem__(self, key, value):
        size = _nbytes(value)
        with self._lock:
            if self.max_bytes is not None and size > self.max_bytes:
                # one value over the whole cap: don't thrash — and leave
                # any existing entry for the key in place (values here are
                # deterministic per key, so the old one is still right)
                return
            old = self._d.pop(key, None)
            if old is not None:
                self.nbytes -= old[1]
            self._d[key] = (value, size)
            self.nbytes += size
            if self.max_bytes is not None:
                while self.nbytes > self.max_bytes and self._d:
                    _, (_, evicted_size) = self._d.popitem(last=False)
                    self.nbytes -= evicted_size
                    self.evictions += 1

    def clear(self):
        with self._lock:
            self._d.clear()
            self.nbytes = 0


class FrameDiskCache:
    """Persistent decoded-frame store.

    Layout (version 3): `frames_{H}x{W}.bin` holds HEADERLESS fixed-size
    records of exactly H*W*3 uint8 (the resized RGB frame) so a record IS
    a frame — `preadv` can land contiguous runs of records straight into
    the caller's preallocated clip array with zero intermediate copies
    (the clip assembly copy dominated the disk-cold input pipeline
    otherwise). `frames_{H}x{W}.idx` holds one `path\\tw\\th\\tsrcbytes`
    line per record in order (the ORIGINAL image size and the source
    file's byte size travel in the index). A VERSION file guards the
    layout; a non-matching store from an older build is discarded (it is
    a cache).

    Staleness: records are keyed by path, so a regenerated dataset at the
    same paths would silently serve old pixels forever. Guard: each
    record stores its source file's byte size, and open() stats a random
    sample of entries — any size mismatch marks the store stale, which a
    writer wipes (decode re-pays once) and a reader ignores. Per-read
    validation is deliberately skipped (a stat per frame on the preadv
    hot path); a same-size re-encode can slip through the sample, which
    is the documented trade-off of a path-keyed cache.

    Decoder provenance: native-libjpeg and PIL pixels drift on downscale
    paths, so a store remembers which decoder produced it (`decoder` tag,
    persisted in `frames_{H}x{W}.dec`). Opening with a different tag
    wipes the store (writer) or ignores it (reader) — a warm
    `--frame-cache-dir` can never serve the other decoder's pixels to a
    run that asked for exact-PIL parity. An empty tag skips the check
    (direct library use that manages its own store discipline).

    Reads are positional (`pread`/`preadv` on a shared fd — no file
    position state, safe under the loader's thread pool); appends hold a
    lock. Crash recovery: the store is authoritative up to the shorter of
    the two files — BOTH the .bin and the .idx truncate to that point on
    writer open (a stale idx line left behind would otherwise realign
    with a later-appended record and serve the wrong frame forever).

    Cross-process: the writer role is guarded by an flock'd lockfile —
    exactly one process appends/truncates; any other process sharing the
    directory opens READ-ONLY (its `put` is a no-op and nothing is
    truncated under the writer's feet). Readers see the record prefix
    indexed at their open; they pick up the writer's additions on their
    next open."""

    VERSION = "3"

    def __init__(self, cache_dir: str, height: int, width: int,
                 decoder: str = ""):
        self.height = height
        self.width = width
        self.rec_bytes = height * width * 3
        os.makedirs(cache_dir, exist_ok=True)
        self.bin_path = osp.join(cache_dir, f"frames_{height}x{width}.bin")
        self.idx_path = osp.join(cache_dir, f"frames_{height}x{width}.idx")
        self.dec_path = osp.join(cache_dir, f"frames_{height}x{width}.dec")
        self.decoder = decoder
        ver_path = osp.join(cache_dir, "VERSION")
        self._lock = threading.Lock()

        # single-writer flock (per store, i.e. per (dir, H, W))
        self._lock_fd = os.open(
            osp.join(cache_dir, f"frames_{height}x{width}.lock"),
            os.O_CREAT | os.O_RDWR,
            0o644,
        )
        try:
            import fcntl

            fcntl.flock(self._lock_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            self.read_only = False
        except OSError:
            self.read_only = True

        try:
            with open(ver_path) as f:
                ver = f.read().strip()
        except OSError:
            ver = None
        if ver != self.VERSION and not self.read_only:
            for p in (self.bin_path, self.idx_path):
                if osp.exists(p):
                    os.remove(p)
            with open(ver_path, "w") as f:
                f.write(self.VERSION)

        # decoder-provenance tag: never serve the other decoder's pixels
        dec_mismatch = False
        if decoder:
            try:
                with open(self.dec_path) as f:
                    have = f.read().strip()
            except OSError:
                have = None
            if have != decoder:
                has_records = (
                    osp.exists(self.bin_path)
                    and os.path.getsize(self.bin_path) >= self.rec_bytes
                )
                if has_records:
                    print(
                        f"Frame store {self.bin_path}: pixels decoded by "
                        f"'{have or 'an unknown decoder'}', this run uses "
                        f"'{decoder}' — "
                        + ("discarding the store" if not self.read_only
                           else "ignoring it (read-only)")
                    )
                if not self.read_only:
                    for p in (self.bin_path, self.idx_path):
                        if osp.exists(p):
                            os.remove(p)
                    with open(self.dec_path, "w") as f:
                        f.write(decoder)
                else:
                    dec_mismatch = True

        open(self.bin_path, "ab").close()
        open(self.idx_path, "ab").close()
        self._index: dict[str, int] = {}
        self._sizes: list[tuple[int, int]] = []
        self._src_bytes: list[int] = []
        if (ver != self.VERSION or dec_mismatch) and self.read_only:
            # a reader cannot wipe a mismatched store; treat it as empty
            lines = []
        else:
            with open(self.idx_path, "r") as f:
                lines = f.read().splitlines()
        full_records = os.path.getsize(self.bin_path) // self.rec_bytes
        n = 0
        for line in lines[: full_records]:
            try:
                p, w, h, sb = line.rsplit("\t", 3)
                wh = (int(w), int(h))
                sb = int(sb)
            except ValueError:
                break  # malformed tail line
            self._index[p] = n
            self._sizes.append(wh)
            self._src_bytes.append(sb)
            n += 1
        self._n = n

        if n and self._sample_stale():
            # the dataset changed under the store's paths: a writer wipes
            # and re-pays decode once; a reader cannot wipe — serve nothing
            print(
                f"Frame store {self.bin_path}: source files changed size — "
                + ("discarding the stale store"
                   if not self.read_only else "ignoring it (read-only)")
            )
            self._index.clear()
            self._sizes.clear()
            self._src_bytes.clear()
            self._n = n = 0
            lines = []
            if not self.read_only:
                for p in (self.bin_path, self.idx_path):
                    with open(p, "w"):
                        pass
        # data reads via pread on a shared fd; appends via buffered handles
        self._read_fd = os.open(self.bin_path, os.O_RDONLY)
        if not self.read_only:
            # drop any partial trailing record AND the idx lines beyond the
            # recovered prefix — both files must agree record-for-line (a
            # stale idx line would realign with the next appended record
            # and serve the wrong frame)
            self._bin_append = open(self.bin_path, "r+b")
            self._bin_append.seek(n * self.rec_bytes)
            self._bin_append.truncate()
            if len(lines) != n:
                with open(self.idx_path, "w") as f:
                    f.write("".join(
                        f"{p}\t{w}\t{h}\t{sb}\n"
                        for p, (w, h), sb in zip(
                            self._index, self._sizes, self._src_bytes
                        )
                    ))
            self._idx_append = open(self.idx_path, "a")
        else:
            self._bin_append = None
            self._idx_append = None

    def __len__(self):
        return self._n

    def _sample_stale(self, sample: int = 64) -> bool:
        """Stat a deterministic sample of indexed paths: True if any
        still-existing source file's byte size differs from the one
        recorded at put time. Missing files don't count — a store may
        outlive a dataset tree whose frames are simply never requested."""
        paths = list(self._index)
        step = max(1, len(paths) // sample)
        for p in paths[::step][:sample]:
            try:
                actual = os.path.getsize(p)
            except OSError:
                continue
            if actual != self._src_bytes[self._index[p]]:
                return True
        return False

    def get(self, path: str):
        """-> (frame (H, W, 3) uint8, (w, h)) or None."""
        i = self._index.get(path)
        if i is None:
            return None
        raw = os.pread(self._read_fd, self.rec_bytes, i * self.rec_bytes)
        if len(raw) != self.rec_bytes:
            return None
        img = np.frombuffer(raw, np.uint8).reshape(self.height, self.width, 3)
        return img, self._sizes[i]

    def read_many_into(self, paths, out: np.ndarray, rows):
        """Read `paths[k]` into `out[rows[k]]` (each a contiguous
        (H, W, 3) uint8 row of a batch array). Consecutive store records
        land in ONE preadv call — clips are written in order at populate
        time, so a clip is typically a single contiguous run. Returns a
        list of (w, h) per path, None where the store has no record (the
        caller decodes those; their rows are untouched)."""
        n = len(paths)
        recs = [self._index.get(p) for p in paths]
        sizes: list = [None] * n
        MAX_RUN = 256  # stay well under IOV_MAX and keep short-read retries cheap
        i = 0
        while i < n:
            if recs[i] is None:
                i += 1
                continue
            j = i
            while (
                j + 1 < n and j + 1 - i < MAX_RUN and recs[j + 1] == recs[j] + 1
            ):
                j += 1
            bufs = [
                memoryview(out[rows[k]]).cast("B", shape=[self.rec_bytes])
                for k in range(i, j + 1)
            ]
            got = os.preadv(self._read_fd, bufs, recs[i] * self.rec_bytes)
            full = got // self.rec_bytes  # complete records read (short
            # reads leave the tail as misses for the caller to decode)
            for k in range(i, i + full):
                sizes[k] = self._sizes[recs[k]]
            i = j + 1
        return sizes

    def put(self, path: str, img: np.ndarray, size) -> None:
        if self.read_only:  # another process holds the writer lock
            return
        if img.shape != (self.height, self.width, 3) or img.dtype != np.uint8:
            raise ValueError(f"a ({self.height}, {self.width}, 3) uint8 frame, got "
                             f"{img.shape} {img.dtype}")
        try:
            src_bytes = os.path.getsize(path)  # staleness fingerprint
        except OSError:
            src_bytes = -1  # non-file source (tests); never flags stale
        with self._lock:
            if path in self._index:
                return
            self._bin_append.write(np.ascontiguousarray(img).tobytes())
            self._bin_append.flush()
            self._idx_append.write(
                f"{path}\t{int(size[0])}\t{int(size[1])}\t{src_bytes}\n"
            )
            self._idx_append.flush()
            # publish order matters: get()/read_many_into() take no lock,
            # so _sizes must be complete BEFORE the path appears in _index
            # (index-first briefly exposed _sizes[i] -> IndexError)
            self._sizes.append((int(size[0]), int(size[1])))
            self._src_bytes.append(src_bytes)
            self._index[path] = self._n
            self._n += 1

    def close(self):
        with self._lock:
            for fd in (self._read_fd, self._lock_fd):
                try:
                    os.close(fd)  # closing releases the flock
                except OSError:
                    pass
            if self._bin_append is not None:
                self._bin_append.close()
            if self._idx_append is not None:
                self._idx_append.close()
            self._index.clear()


def host_available_gb() -> float:
    """MemAvailable from /proc/meminfo (GB); +inf when unreadable (the
    caller then falls back to the flag default rather than guessing)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024 / 1e9
    except OSError:
        pass
    return float("inf")


DEFAULT_CACHE_GB = 8.0
# never auto-claim more than this fraction of MemAvailable: the rest of
# the run needs headroom for batches in flight, pinned staging buffers, and the
# item-cache share of the same LRU
AUTO_CACHE_RAM_FRAC = 0.4


def resolve_cache_budget(cache_gb_flag, eval_gb: float, avail_gb=None):
    """--cache-gb resolution.

    `cache_gb_flag` None = auto: start from DEFAULT_CACHE_GB and RAISE the
    budget to hold the collated eval batch set (`eval_gb` + 10% headroom
    for the train item-cache share) whenever that fits inside
    AUTO_CACHE_RAM_FRAC of MemAvailable — deterministic eval loaders cache
    whole collated batches, so repeat evals are host-free exactly when the
    eval set fits the LRU (an undersized LRU gets ~0 hits on the cyclic
    eval scan). An explicit flag always wins; <= 0 = unbounded.

    Returns (cap_bytes or None, human-readable reason)."""
    if cache_gb_flag is not None:
        if cache_gb_flag <= 0:
            return None, "UNBOUNDED (--cache-gb <= 0)"
        return int(cache_gb_flag * 1e9), f"{cache_gb_flag:g} GB cap (--cache-gb)"
    if avail_gb is None:
        avail_gb = host_available_gb()
    budget = DEFAULT_CACHE_GB
    want = eval_gb * 1.1
    if want > budget:
        if want <= AUTO_CACHE_RAM_FRAC * avail_gb:
            budget = want
            reason = (
                f"{budget:.1f} GB cap (auto-raised to hold the ~{eval_gb:.1f} GB "
                f"collated eval set; fits {AUTO_CACHE_RAM_FRAC:.0%} of "
                f"{avail_gb:.0f} GB available RAM)"
            )
        else:
            reason = (
                f"{budget:g} GB cap (default; holding the ~{eval_gb:.1f} GB "
                f"eval set would need {want:.1f} GB > "
                f"{AUTO_CACHE_RAM_FRAC:.0%} of {avail_gb:.0f} GB available "
                "RAM — repeat evals will pay the disk/decode rate; raise "
                "--cache-gb to override)"
            )
        return int(budget * 1e9), reason
    return int(budget * 1e9), f"{budget:g} GB cap (default)"


def estimate_cache_gb(datasets, height: int, width: int) -> float:
    """Startup RAM estimate for --cache-frames: distinct frames across the
    given tracklet lists x H*W*3 bytes, in GB."""
    paths = set()
    for tracklets in datasets:
        for entry in tracklets:
            img_paths = entry[0]
            if isinstance(img_paths, str):
                img_paths = (img_paths,)
            paths.update(img_paths)
    return len(paths) * height * width * 3 / 1e9
