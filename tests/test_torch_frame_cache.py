"""The port's frame caches (agrl_torch/data/cache.py) held against
agrl_tpu's (agrl_tpu/data/cache.py): the LRU's evictions under one seeded
sequence, FrameDiskCache stores read across the two packages bit for bit,
the store's guards (decoder tag, staleness, crash truncation, the
read-only second opener, preadv runs) and the budget helpers."""

import os

import numpy as np
import pytest

from agrl_torch.data import cache as tc
from agrl_tpu.data import cache as jc


def _frame(seed, h=8, w=4):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("cap", [None, 3000, 1])
def test_bounded_cache_evicts_as_agrl_tpu(cap):
    rng = np.random.RandomState(5)
    t, j = tc.BoundedCache(cap), jc.BoundedCache(cap)
    for _ in range(400):
        key = f"k{rng.randint(12)}"
        if rng.rand() < 0.55:
            size = rng.randint(1, 600)
            value = (np.zeros(size, np.uint8), (rng.randint(9), 1)) if rng.rand() < 0.5 \
                else np.zeros(size, np.uint8)
            t[key], j[key] = value, value
        else:
            a, b = t.get(key), j.get(key)
            assert (a is None) == (b is None)
        assert list(t._d) == list(j._d)
        assert (t.nbytes, t.evictions, len(t)) == (j.nbytes, j.evictions, len(j))
    t.clear()
    assert len(t) == 0 and t.nbytes == 0


@pytest.mark.parametrize("writer,reader", [(jc, tc), (tc, jc)])
def test_frame_store_reads_across_packages(writer, reader, tmp_path):
    """A store written by one package (decoder tag pil) is read by the
    other bit for bit: records, original sizes and the preadv path."""
    d = str(tmp_path / "store")
    w = writer.FrameDiskCache(d, 8, 4, decoder="pil")
    frames = {f"/data/p{i}.jpg": (_frame(i), (40 + i, 80 + i)) for i in range(7)}
    for p, (img, size) in frames.items():
        w.put(p, img, size)
    w.close()
    r = reader.FrameDiskCache(d, 8, 4, decoder="pil")
    assert len(r) == 7 and not r.read_only
    for p, (img, size) in frames.items():
        got, got_size = r.get(p)
        np.testing.assert_array_equal(got, img)
        assert got_size == size
    paths = ["/data/p5.jpg", "/data/p6.jpg", "/data/p0.jpg", "/none.jpg", "/data/p5.jpg"]
    out = np.zeros((len(paths), 8, 4, 3), np.uint8)
    sizes = r.read_many_into(paths, out, list(range(len(paths))))
    assert sizes == [frames[p][1] if p in frames else None for p in paths]
    for k, p in enumerate(paths):
        if p in frames:
            np.testing.assert_array_equal(out[k], frames[p][0])
    assert not out[3].any()
    # the reader appends, and the writer's package reads it back
    r.put("/data/new.jpg", _frame(99), (1, 2))
    r.close()
    w2 = writer.FrameDiskCache(d, 8, 4, decoder="pil")
    np.testing.assert_array_equal(w2.get("/data/new.jpg")[0], _frame(99))
    w2.close()
    for name in ("VERSION", "frames_8x4.bin", "frames_8x4.idx", "frames_8x4.dec"):
        assert os.path.exists(os.path.join(d, name))


def test_decoder_tag_guards_the_store(tmp_path, capsys):
    d = str(tmp_path / "s")
    a = tc.FrameDiskCache(d, 8, 4, decoder="native")
    a.put("/x.jpg", _frame(1), (4, 8))
    a.close()
    ro_holder = tc.FrameDiskCache(d, 8, 4, decoder="native")  # holds the writer lock
    reader = tc.FrameDiskCache(d, 8, 4, decoder="pil")
    assert reader.read_only and len(reader) == 0  # ignored, not wiped
    assert "ignoring it (read-only)" in capsys.readouterr().out
    reader.close()
    ro_holder.close()
    writer = tc.FrameDiskCache(d, 8, 4, decoder="pil")
    assert len(writer) == 0 and "discarding the store" in capsys.readouterr().out
    writer.close()
    with open(os.path.join(d, "frames_8x4.dec")) as f:
        assert f.read() == "pil"


def test_stale_sources_discard_the_store(tmp_path, capsys):
    src = tmp_path / "f.jpg"
    src.write_bytes(b"x" * 100)
    d = str(tmp_path / "s")
    s = tc.FrameDiskCache(d, 8, 4, decoder="pil")
    s.put(str(src), _frame(2), (4, 8))
    s.close()
    src.write_bytes(b"x" * 101)  # regenerated at the same path
    s2 = tc.FrameDiskCache(d, 8, 4, decoder="pil")
    assert len(s2) == 0 and "source files changed size" in capsys.readouterr().out
    s2.close()


def test_crash_truncation_drops_the_partial_record_and_its_line(tmp_path):
    d = str(tmp_path / "s")
    s = tc.FrameDiskCache(d, 8, 4)
    for i in range(3):
        s.put(f"p{i}", _frame(i), (4, 8))
    s.close()
    with open(os.path.join(d, "frames_8x4.bin"), "r+b") as f:
        f.truncate(2 * 8 * 4 * 3 + 17)  # a crash mid third record
    s2 = tc.FrameDiskCache(d, 8, 4)
    assert len(s2) == 2 and s2.get("p2") is None
    s2.put("new", _frame(9), (4, 8))
    s2.close()
    j = jc.FrameDiskCache(d, 8, 4)  # agrl_tpu agrees record for line
    assert j.get("p2") is None
    np.testing.assert_array_equal(j.get("new")[0], _frame(9))
    np.testing.assert_array_equal(j.get("p1")[0], _frame(1))
    j.close()


def test_second_opener_is_read_only(tmp_path):
    d = str(tmp_path / "s")
    a = tc.FrameDiskCache(d, 8, 4)
    a.put("p0", _frame(0), (4, 8))
    b = jc.FrameDiskCache(d, 8, 4)  # across packages too: one writer per store
    assert not a.read_only and b.read_only
    np.testing.assert_array_equal(b.get("p0")[0], _frame(0))
    b.put("px", _frame(5), (4, 8))
    assert b.get("px") is None
    b.close()
    a.close()
    with pytest.raises(ValueError, match="uint8 frame"):
        c = tc.FrameDiskCache(d, 8, 4)
        try:
            c.put("bad", np.zeros((8, 4, 3), np.float32), (4, 8))
        finally:
            c.close()


def test_read_many_into_runs_longer_than_one_preadv(tmp_path):
    s = tc.FrameDiskCache(str(tmp_path / "s"), 2, 2)
    n = 600  # > MAX_RUN = 256: several preadv calls for one run
    for i in range(n):
        s.put(f"f{i}", _frame(i, 2, 2), (2, 2))
    out = np.zeros((n, 2, 2, 3), np.uint8)
    sizes = s.read_many_into([f"f{i}" for i in range(n)], out, list(range(n)))
    assert all(sz == (2, 2) for sz in sizes)
    for i in (0, 255, 256, 511, 599):
        np.testing.assert_array_equal(out[i], _frame(i, 2, 2))
    s.close()


@pytest.mark.parametrize("flag,eval_gb,avail", [
    (None, 45.0, 512.0), (None, 45.0, 64.0), (None, 1.0, 64.0), (3.0, 45.0, 512.0),
    (0.0, 1.0, 64.0), (-1.0, 1.0, 64.0)])
def test_budget_helpers_match_agrl_tpu(flag, eval_gb, avail):
    assert tc.resolve_cache_budget(flag, eval_gb, avail) == \
        jc.resolve_cache_budget(flag, eval_gb, avail)
    tracklets = [(("a.jpg", "b.jpg"), 0, 0), (("b.jpg", "c.jpg"), 1, 0)]
    for sets in ([tracklets], [tracklets, [("d.jpg", 0, 0)]]):
        assert tc.estimate_cache_gb(sets, 256, 128) == jc.estimate_cache_gb(sets, 256, 128)
    assert tc.host_available_gb() > 0
