"""The port's dataset catalogs held against agrl_tpu's on the fake trees
of tests/test_catalogs.py (plus a pose.json each): the same train, query
and gallery lists, pid counts and poses, the same integrity failures, the
same caches; and materialize_mars_layout writing the same files."""

import json
import os
import os.path as osp
import shutil
import tarfile

import numpy as np
import pytest

from agrl_torch.data.datasets import get_names as torch_names
from agrl_torch.data.datasets import init_vidreid_dataset as torch_dataset
from agrl_torch.data.datasets.synthetic_mars import materialize_mars_layout as torch_materialize
from agrl_tpu.data.datasets import get_names as jax_names
from agrl_tpu.data.datasets import init_vidreid_dataset as jax_dataset
from agrl_tpu.data.datasets.synthetic_mars import materialize_mars_layout as jax_materialize
from tests.test_catalogs import _build_ilids_tree, make_mars, touch


def _poses(d, keys):
    """A pose.json under dataset dir `d`: one or two bodies per key."""
    rng = np.random.RandomState(len(keys))
    raw = {k: {"bodies": [{"joints": rng.rand(54).tolist(), "score": float(s)}
                          for s in rng.rand(1 + i % 2) + 1]}
           for i, k in enumerate(keys)}
    with open(osp.join(d, "pose.json"), "w") as f:
        json.dump(raw, f)


def tree_mars(root):
    d = make_mars(root)
    _poses(d, ["0007C1T0001F001.jpg", "0011C2T0001F002.jpg"])
    return "mars", {}, ()


def tree_ilidsvid(root):
    d = _build_ilids_tree(root)
    _poses(d, ["cam1_person001_00001.png"])
    return "ilidsvid", {"split_id": 3}, ("splits.json",)


def tree_prid2011(root):
    d = osp.join(root, "prid2011")
    ms = osp.join(d, "prid_2011", "multi_shot")
    people = [f"person_{i:04d}" for i in range(1, 7)]
    for cam in ("cam_a", "cam_b"):
        for p in people:
            for f in range(2):
                touch(osp.join(ms, cam, p, f"{f:04d}.png"))
    with open(osp.join(d, "splits_prid2011.json"), "w") as f:
        json.dump([{"train": people[:3], "test": people[3:]},
                   {"train": people[3:], "test": people[:3]}], f)
    _poses(d, ["cam_a-person_0001-0000.png"])
    return "prid2011", {"split_id": 1}, ()


def tree_duke(root):
    base = osp.join(root, "dukemtmc-vidreid", "DukeMTMC-VideoReID")
    for path in ("train/0148/0001/0148_C5_F0001_X1.jpg", "train/0148/0001/0148_C5_F0002_X2.jpg",
                 "train/0152/0001/0152C3F0001X9.jpg", "train/0152/0001/0152C3F0003X9.jpg",
                 "query/0148/0002/0148_C1_F0001_X3.jpg",
                 "gallery/0148/0003/0148_C2_F0001_X4.jpg"):
        touch(osp.join(base, path))
    _poses(osp.join(root, "dukemtmc-vidreid"), ["0148-0001-0148_C5_F0001_X1.jpg"])
    return "dukemtmcvidreid", {}, ("split_train.json", "split_query.json", "split_gallery.json")


def tree_synthetic(root):
    return "synthetic", {"num_pids": 3, "tracklets_per_pid": 2, "frames_per_tracklet": (3, 6),
                         "height": 16, "width": 8}, ()


TREES = {"mars": tree_mars, "ilidsvid": tree_ilidsvid, "prid2011": tree_prid2011,
         "dukemtmcvidreid": tree_duke, "synthetic": tree_synthetic}


def test_registry_matches_agrl_tpu():
    assert torch_names() == jax_names() == list(TREES)


def _same(tds, jds):
    for split in ("train", "query", "gallery"):
        assert getattr(tds, split) == getattr(jds, split), split
    for n in ("num_train_pids", "num_query_pids", "num_gallery_pids"):
        assert getattr(tds, n) == getattr(jds, n), n
    assert tds.process_poses.keys() == jds.process_poses.keys()
    for k, v in tds.process_poses.items():
        np.testing.assert_array_equal(v, jds.process_poses[k])


@pytest.mark.parametrize("name", sorted(TREES))
def test_catalog_matches_agrl_tpu(name, tmp_path, capsys):
    """Each catalog builds its caches on first use (iLIDS-VID splits.json,
    Duke split_*.json): the port builds them, then agrl_tpu builds them
    anew, and both catalogs and caches must agree."""
    root = str(tmp_path)
    key, kwargs, caches = TREES[name](root)
    tds = torch_dataset(key, root=root, verbose=True, **kwargs)
    t_out = capsys.readouterr().out
    cache_dir = osp.join(root, {"ilidsvid": "ilids-vid", "dukemtmcvidreid":
                                "dukemtmc-vidreid"}.get(name, name))
    t_caches = {c: open(osp.join(cache_dir, c)).read() for c in caches}
    for c in caches:
        os.remove(osp.join(cache_dir, c))
    if name == "synthetic":
        kwargs["materialize"] = False  # the port wrote the frames
    jds = jax_dataset(key, root=root, verbose=True, **kwargs)
    assert capsys.readouterr().out == t_out  # the stats table, letter for letter
    _same(tds, jds)
    assert tds.train and tds.process_poses
    for c in caches:
        assert open(osp.join(cache_dir, c)).read() == t_caches[c], c


def test_mars_integrity_assert_fires_alike(tmp_path):
    d = make_mars(str(tmp_path))
    names_file = osp.join(d, "info", "train_name.txt")
    with open(names_file) as f:
        names = f.read().splitlines()
    names[1] = "0008" + names[1][4:]  # tracklet 1 now spans two persons
    with open(names_file, "w") as f:
        f.write("\n".join(names) + "\n")
    errors = []
    for init in (torch_dataset, jax_dataset):
        with pytest.raises(AssertionError) as exc:
            init("mars", root=str(tmp_path), verbose=False, use_pose=False)
        errors.append(str(exc.value))
    assert errors[0] == errors[1] and "different person" in errors[0]


def test_ilidsvid_download_path(tmp_path, monkeypatch):
    """--download fetches and extracts the tar once (urlretrieve replaced
    by a local copy: nothing is fetched)."""
    import urllib.request

    from agrl_torch.data.datasets.ilidsvid import iLIDSVID

    d = _build_ilids_tree(str(tmp_path / "remote"))
    tar_path = str(tmp_path / "iLIDS-VID.tar")
    with tarfile.open(tar_path, "w") as tar:
        tar.add(osp.join(d, "i-LIDS-VID"), arcname="i-LIDS-VID")
        tar.add(osp.join(d, "train-test people splits"), arcname="train-test people splits")
    calls = []
    monkeypatch.setattr(urllib.request, "urlretrieve",
                        lambda url, fpath: (calls.append(url), shutil.copy(tar_path, fpath)))
    kw = dict(root=str(tmp_path / "local"), verbose=False, use_pose=False, download=True)
    ds = torch_dataset("ilidsvid", **kw)
    torch_dataset("ilidsvid", **kw)
    assert calls == [iLIDSVID.dataset_url]
    _same(ds, jax_dataset("ilidsvid", **kw))
    assert len(calls) == 1


def test_materialize_mars_layout_writes_the_same_files(tmp_path):
    """Byte-equal files; a .mat file's 116-byte header text holds its
    creation time, so .mat files are compared after it and by content."""
    from scipy.io import loadmat

    kw = dict(num_train_pids=2, num_test_pids=2, tracklets_per_cam=1, frames_range=(3, 4),
              height=32, width=16, seed=5)
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    torch_materialize(a, **kw)
    jax_materialize(b, **kw)
    files = sorted(osp.relpath(osp.join(dp, f), a) for dp, _, fs in os.walk(a) for f in fs)
    assert files == sorted(osp.relpath(osp.join(dp, f), b) for dp, _, fs in os.walk(b)
                           for f in fs)
    assert sum(f.endswith(".jpg") for f in files) > 10
    for rel in files:
        x = open(osp.join(a, rel), "rb").read()
        y = open(osp.join(b, rel), "rb").read()
        if rel.endswith(".mat"):
            assert x[116:] == y[116:], rel
            mx, my = loadmat(osp.join(a, rel)), loadmat(osp.join(b, rel))
            for k in mx:
                if not k.startswith("__"):
                    np.testing.assert_array_equal(mx[k], my[k])
        else:
            assert x == y, rel
    tds = torch_dataset("mars", root=a, verbose=False)
    jds = jax_dataset("mars", root=b, verbose=False)
    for split in ("train", "query", "gallery"):
        rel = [(tuple(osp.relpath(p, a) for p in t[0]),) + t[1:] for t in getattr(tds, split)]
        assert rel == [(tuple(osp.relpath(p, b) for p in t[0]),) + t[1:]
                       for t in getattr(jds, split)]
    assert tds.process_poses.keys() == jds.process_poses.keys()
