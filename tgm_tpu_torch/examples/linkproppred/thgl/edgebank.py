"""EdgeBank on thgl-* heterogeneous temporal graphs
(``examples/linkproppred/thgl/edgebank.py``).

    python -m tgm_tpu_torch.examples.linkproppred.thgl.edgebank --dataset thgl-<name> [...]

The EdgeBank example with the THG (node-type-constrained) candidate hook;
``synthetic[-N-E]`` names hand it the synthetic candidate arrays.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ....hooks import TGBTHGNegativeEdgeSamplerHook
from .. import edgebank


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    return edgebank.main(argv, neg_hook=TGBTHGNegativeEdgeSamplerHook)


if __name__ == "__main__":
    main()
