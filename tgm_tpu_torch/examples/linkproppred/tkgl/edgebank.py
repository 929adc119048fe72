"""EdgeBank on tkgl-* temporal knowledge graphs
(``examples/linkproppred/tkgl/edgebank.py``).

    python -m tgm_tpu_torch.examples.linkproppred.tkgl.edgebank --dataset tkgl-<name> [...]

The EdgeBank example with the TKG (destination-range) candidate hook;
``synthetic[-N-E]`` names hand it the synthetic candidate arrays.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ....hooks import TGBTKGNegativeEdgeSamplerHook
from .. import edgebank


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    return edgebank.main(argv, neg_hook=TGBTKGNegativeEdgeSamplerHook)


if __name__ == "__main__":
    main()
