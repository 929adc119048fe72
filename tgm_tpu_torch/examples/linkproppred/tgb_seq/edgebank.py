"""EdgeBank on TGB-Seq datasets (``examples/linkproppred/tgb_seq/edgebank.py``).

    python -m tgm_tpu_torch.examples.linkproppred.tgb_seq.edgebank --dataset <name> [...]

The EdgeBank example over ``DGData.from_tgb_seq(name)`` (the optional
``tgb-seq`` package); ``synthetic[-N-E]`` names run the synthetic stream.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ....data import DGData
from ..._datasets import load_dataset
from .. import edgebank


def load_seq(name: str):
    if name.startswith("synthetic"):
        return load_dataset(name)
    return DGData.from_tgb_seq(name), None, None


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    return edgebank.main(argv, load=load_seq)


if __name__ == "__main__":
    main()
