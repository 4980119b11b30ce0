"""Dataset catalog registry (counterpart of agrl_tpu/data/datasets).

Only the synthetic fixture is ported so far; the MARS, iLIDS-VID,
PRID2011 and DukeMTMC-VideoReID catalogs follow later."""

from __future__ import annotations

from agrl_torch.data.datasets.synthetic import SyntheticVidReid

__vidreid_factory = {
    "synthetic": SyntheticVidReid,
}


def get_names():
    return list(__vidreid_factory.keys())


def init_vidreid_dataset(name: str, **kwargs):
    if name not in __vidreid_factory:
        raise KeyError(f"Invalid dataset, got '{name}', but expected to be one of {get_names()}")
    return __vidreid_factory[name](**kwargs)
