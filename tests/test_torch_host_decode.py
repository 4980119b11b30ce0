"""The port's host decode (agrl_torch/data/transforms.py, data/jpeg_native.py)
held against agrl_tpu's: the PIL path bit for bit, the native decoder's
bars from tests/test_jpeg_native.py, the failure cases, and decode through
the RAM and disk caches. The native decoder is built by the port into
agrl_torch/_build at first use; its tests skip, with the reason, only
where it cannot be built (no g++ or no libjpeg headers)."""

import os
import re
import shutil

import numpy as np
import pytest
from PIL import Image

from agrl_torch.data import jpeg_native
from agrl_torch.data import transforms as ttr
from agrl_torch.data.cache import BoundedCache as TorchBoundedCache
from agrl_torch.data.cache import FrameDiskCache as TorchFrameDiskCache
from agrl_tpu.data import transforms as jtr
from agrl_tpu.data.cache import BoundedCache as JaxBoundedCache
from agrl_tpu.data.cache import FrameDiskCache as JaxFrameDiskCache


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """tests/test_jpeg_native.py's set: two frames at 128x256, one at 64x128
    and one at 300x500 (the DCT downscale path), smooth content; plus a
    PNG."""
    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.RandomState(0)
    paths = []
    for i, (w, h) in enumerate([(128, 256), (128, 256), (64, 128), (300, 500)]):
        small = (rng.rand(h // 8, w // 8, 3) * 255).astype(np.uint8)
        p = str(root / f"{i}.jpg")
        Image.fromarray(small).resize((w, h), Image.BILINEAR).save(p, quality=92)
        paths.append(p)
    png = str(root / "4.png")
    Image.fromarray((rng.rand(96, 48, 3) * 255).astype(np.uint8)).save(png)
    return paths, png


@pytest.fixture
def native():
    if not jpeg_native.available():
        pytest.skip(f"the native decoder cannot be built here: {jpeg_native.why_unavailable()}")


def _pil(path, h, w):
    return np.asarray(Image.open(path).convert("RGB").resize((w, h), Image.BILINEAR))


@pytest.mark.parametrize("hw", [(256, 128), (64, 32)])
def test_pil_path_bit_equal_to_agrl_tpu(jpegs, hw):
    paths, png = jpegs
    got, got_sizes = ttr.host_decode_resize(paths + [png], *hw, decode="pil")
    want, want_sizes = jtr.host_decode_resize(paths + [png], *hw, decode="pil")
    assert got.dtype == np.uint8 and got.shape == (5, *hw, 3)
    np.testing.assert_array_equal(got, want)
    assert [tuple(s) for s in got_sizes] == [tuple(s) for s in want_sizes]


def test_native_at_size_is_bit_exact(jpegs, native):
    paths, _ = jpegs
    imgs, sizes, ok = jpeg_native.decode_resize_batch(paths[:2], 256, 128)
    assert ok.all()
    for i in range(2):
        np.testing.assert_array_equal(imgs[i], np.asarray(Image.open(paths[i]).convert("RGB")))
    np.testing.assert_array_equal(sizes, [[128, 256], [128, 256]])
    via_auto, _ = ttr.host_decode_resize(paths[:2], 256, 128, decode="auto")
    np.testing.assert_array_equal(via_auto, imgs)


def test_native_resize_close_to_pil(jpegs, native):
    """tests/test_jpeg_native.py's bound: mean |native - PIL| < 6 gray
    levels per image (two bilinear implementations; the 300x500 source
    takes the DCT downscale), and the downscale really differs."""
    paths, _ = jpegs
    imgs, sizes = ttr.host_decode_resize(paths, 256, 128, decode="native")
    pil, _ = ttr.host_decode_resize(paths, 256, 128, decode="pil")
    for i in range(len(paths)):
        diff = np.abs(imgs[i].astype(int) - pil[i].astype(int))
        assert diff.mean() < 6.0, (i, diff.mean())
    assert np.abs(imgs[3].astype(int) - pil[3].astype(int)).max() > 0
    assert sizes[3] == (300, 500)


def test_native_failures_are_zero_filled_and_retried_by_pil(jpegs, native, tmp_path,
                                                            monkeypatch):
    paths, _ = jpegs
    data = open(paths[0], "rb").read()
    trunc = str(tmp_path / "trunc.jpg")
    open(trunc, "wb").write(data[: len(data) // 2])
    garbage = str(tmp_path / "garbage.jpg")
    open(garbage, "wb").write(b"\xff\xd8" + np.random.RandomState(3).bytes(4096))
    missing = str(tmp_path / "nope.jpg")
    imgs, sizes, ok = jpeg_native.decode_resize_batch(
        [paths[0], trunc, garbage, missing], 64, 32)
    assert ok.tolist() == [True, False, False, False]
    assert not imgs[1:].any() and (sizes[3] == 0).all()
    # a frame the native decoder fails on goes to the robust PIL reader
    good = str(tmp_path / "good.jpg")
    Image.fromarray(_pil(paths[2], 64, 32)).save(good)
    calls = []
    real = ttr._pil_decode_one

    def spy(path, h, w):
        calls.append(path)
        return real(path, h, w)

    real_native = jpeg_native.decode_resize_batch

    def one_fails(paths_, h, w, threads=1):
        out, sz, okk = real_native(paths_, h, w, threads)
        out[1], sz[1], okk[1] = 0, 0, False
        return out, sz, okk

    monkeypatch.setattr(ttr, "_pil_decode_one", spy)
    monkeypatch.setattr(jpeg_native, "decode_resize_batch", one_fails)
    got, got_sizes = ttr.host_decode_resize([paths[2], good], 64, 32, decode="native")
    assert calls == [good]
    np.testing.assert_array_equal(got[1], _pil(good, 64, 32))
    assert got_sizes[1] == (32, 64)


def test_native_refuses_a_non_jpeg_and_auto_takes_pil(jpegs, native):
    paths, png = jpegs
    with pytest.raises(ValueError, match="not a JPEG"):
        ttr.host_decode_resize([paths[0], png], 64, 32, decode="native")
    got, sizes = ttr.host_decode_resize([png], 64, 32, decode="auto")
    np.testing.assert_array_equal(got[0], _pil(png, 64, 32))
    assert sizes == [(48, 96)]


def test_native_unbuilt_raises_with_its_reason(jpegs, monkeypatch):
    """decode='native' with the library unbuilt raises (naming why) in
    host_decode_resize and in effective_decoder, before a store opens;
    auto then decodes with PIL."""
    paths, _ = jpegs
    monkeypatch.setattr(jpeg_native, "available", lambda: False)
    monkeypatch.setattr(jpeg_native, "why_unavailable",
                        lambda: "libjpeg_decode not built: jpeglib.h: No such file")
    with pytest.raises(RuntimeError, match="jpeglib.h: No such file"):
        ttr.host_decode_resize(paths[:1], 64, 32, decode="native")
    with pytest.raises(RuntimeError, match="not built"):
        ttr.effective_decoder("native")
    assert ttr.effective_decoder("auto") == "pil" and ttr.effective_decoder("pil") == "pil"
    got, _ = ttr.host_decode_resize(paths, 64, 32, decode="auto")
    want, _ = jtr.host_decode_resize(paths, 64, 32, decode="pil")
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="decode must be one of"):
        ttr.effective_decoder("turbo")


def test_effective_decoder_with_the_library_built(native):
    assert ttr.effective_decoder("auto") == "native"
    assert ttr.effective_decoder("native") == "native"
    assert ttr.effective_decoder("pil") == "pil"
    assert jpeg_native.why_unavailable() is None


# fake compilers in front of g++: the failures of a machine without them
_NO_GOMP = ('for a in "$@"; do [ "$a" = -fopenmp ] && { echo "g++-real: fatal error: cannot '
            'read spec file \'libgomp.spec\': No such file or directory" >&2; exit 1; }; done; '
            'exec g++ "$@"')
_NO_JPEGLIB = ('echo "jpeg_decode.cpp:32:10: fatal error: jpeglib.h: No such file or directory" '
               '>&2; exit 1')


def _fake_cxx(tmp_path, monkeypatch, body):
    from agrl_torch.kernels import build

    if body is None:
        monkeypatch.setenv("CXX", "no-such-compiler-xyz")
    else:
        cxx = tmp_path / "fake-g++"
        cxx.write_text("#!/bin/sh\n" + body + "\n")
        cxx.chmod(0o755)
        monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return build


@pytest.mark.parametrize("case,want", [
    (None, "g++ not found"),
    (_NO_JPEGLIB, "jpeglib.h: No such file or directory"),
])
def test_host_library_reports_why_it_is_not_built(case, want, monkeypatch, tmp_path):
    """A library that cannot be built is reported with its reason (the
    compiler's first error line), once, and lands nothing."""
    build = _fake_cxx(tmp_path, monkeypatch, case)
    lib = build.HostLibrary("jpeg_decode", jpeg_native._declare)
    assert not lib.available()
    assert want in lib.why_unavailable() and lib.why_unavailable().startswith(
        "libjpeg_decode not built: ")
    with pytest.raises(RuntimeError, match=re.escape(want)):
        lib.lib()
    assert not list((tmp_path / "build").glob("*.so"))


def test_host_library_builds_serial_without_openmp(monkeypatch, tmp_path):
    """A compiler without OpenMP's runtime (libgomp) builds the library
    without -fopenmp and says so; the serial scorers agree with NumPy."""
    from agrl_torch.metrics import rank as trank
    from agrl_torch.metrics import rank_native

    if shutil.which("g++") is None:
        pytest.skip("no g++ here to stand behind the fake compiler")
    build = _fake_cxx(tmp_path, monkeypatch, _NO_GOMP)
    lib = build.HostLibrary("rank_eval", rank_native._declare)
    assert lib.available(), lib.why_unavailable()
    assert "without -fopenmp" in lib.note and "libgomp.spec" in lib.note
    assert lib.path == build.host_library_path(
        "rank_eval", tuple(f for f in build.GXX_FLAGS if f != "-fopenmp"))
    monkeypatch.setattr(rank_native, "LIBRARY", lib)
    rng = np.random.RandomState(0)
    dist = rng.rand(12, 80)
    ids = (rng.randint(0, 6, 12), rng.randint(0, 6, 80), rng.randint(0, 3, 12),
           rng.randint(0, 3, 80))
    cmc_n, map_n = rank_native.evaluate_mars_native(dist, *ids, 20)
    cmc_t, map_t = trank.evaluate_mars(dist, *ids, 20)
    np.testing.assert_allclose(cmc_n, cmc_t, atol=1e-6)
    assert abs(map_n - map_t) < 1e-6


def test_decode_through_both_caches_equals_agrl_tpu(jpegs, tmp_path, monkeypatch):
    """RAM cache, then disk store, then decode, in the PIL mode: the port
    and agrl_tpu fill the same clip (repeats included) and the same cache
    entries; a second call reads no file."""
    paths, png = jpegs
    clip = [paths[0], paths[2], paths[0], png, paths[3], paths[2]]
    t_ram, j_ram = TorchBoundedCache(), JaxBoundedCache()
    t_disk = TorchFrameDiskCache(str(tmp_path / "t"), 64, 32, decoder="pil")
    j_disk = JaxFrameDiskCache(str(tmp_path / "j"), 64, 32, decoder="pil")
    got, got_sizes = ttr.host_decode_resize(clip, 64, 32, cache=t_ram, disk_cache=t_disk,
                                            decode="pil")
    want, want_sizes = jtr.host_decode_resize(clip, 64, 32, cache=j_ram, disk_cache=j_disk,
                                              decode="pil")
    np.testing.assert_array_equal(got, want)
    assert got_sizes == want_sizes and len(t_ram) == len(j_ram) == 4 == len(t_disk)
    assert t_ram.nbytes == j_ram.nbytes
    entry = t_ram.get(paths[0])
    assert entry[0].base is None  # its own memory, not a view of the clip
    # warm: the RAM cache alone, then the disk store alone, decode nothing
    monkeypatch.setattr(ttr, "_decode_batch", None)  # any decode would raise TypeError
    again, _ = ttr.host_decode_resize(clip, 64, 32, cache=t_ram, decode="pil")
    from_disk, disk_sizes = ttr.host_decode_resize(clip, 64, 32, cache=TorchBoundedCache(),
                                                   disk_cache=t_disk, decode="pil")
    np.testing.assert_array_equal(again, got)
    np.testing.assert_array_equal(from_disk, got)
    assert disk_sizes == got_sizes
    t_disk.close()
    j_disk.close()


def test_dataset_decode_mode_reaches_the_decoder(jpegs, native):
    from agrl_torch.data.loader import VideoClipDataset

    paths, _ = jpegs
    items = {}
    for mode in ("pil", "native"):
        ds = VideoClipDataset([(tuple(paths), 0, 0)], seq_len=4, sample="evenly",
                              height=256, width=128, enable_pose=False, decode=mode)
        items[mode] = ds.get_item(0)[0]
    np.testing.assert_array_equal(items["pil"][3], _pil(paths[3], 256, 128))
    assert np.abs(items["native"][3].astype(int) - items["pil"][3].astype(int)).max() > 0
    assert VideoClipDataset([(tuple(paths), 0, 0)]).decode_mode == "pil"


def test_native_build_lands_in_the_package_build_dir(native):
    from agrl_torch.kernels.build import BUILD_DIR, host_library_path

    lib = host_library_path("jpeg_decode")
    assert lib.parent == BUILD_DIR and lib.exists() and lib.with_suffix(".log").exists()
    assert not any(name.endswith(".so") for name in os.listdir(BUILD_DIR.parent.parent / "native"))
