"""The tiny tree of ``tiny.py`` with the SoP configuration shrunk too:
``tiny.make_tiny`` shrinks the configurations it names, and
``usair_sop`` is not one of them."""
from __future__ import annotations

import json
import os

from benchmark.tests.tiny import make_tiny

SMALL_SOP = {"usair_sop": {"graph": {"n": 40}, "features": {"max_degree": 16}}}


def make_tiny_sop(dest: str) -> tuple[str, str]:
    """``tiny.make_tiny(dest)``, then each configuration of
    :data:`SMALL_SOP` cut to its small graph and features."""
    root, bench = make_tiny(dest)
    for name, parts in SMALL_SOP.items():
        path = os.path.join(bench, "configs", name + ".json")
        with open(path) as f:
            config = json.load(f)
        for key, fields in parts.items():
            config[key].update(fields)
        with open(path, "w") as f:
            json.dump(config, f)
    return root, bench
