"""Dataset catalog registry (copy of agrl_tpu/data/datasets/__init__.py;
parity: data_manager/__init__.py:10-25)."""

from __future__ import annotations

from agrl_torch.data.datasets.dukemtmcvidreid import DukeMTMCVidReID
from agrl_torch.data.datasets.ilidsvid import iLIDSVID
from agrl_torch.data.datasets.mars import Mars
from agrl_torch.data.datasets.prid2011 import PRID2011
from agrl_torch.data.datasets.synthetic import SyntheticVidReid

__vidreid_factory = {
    "mars": Mars,
    "ilidsvid": iLIDSVID,
    "prid2011": PRID2011,
    "dukemtmcvidreid": DukeMTMCVidReID,
    "synthetic": SyntheticVidReid,
}


def get_names():
    return list(__vidreid_factory.keys())


def init_vidreid_dataset(name: str, **kwargs):
    if name not in __vidreid_factory:
        raise KeyError(f"Invalid dataset, got '{name}', but expected to be one of {get_names()}")
    return __vidreid_factory[name](**kwargs)
