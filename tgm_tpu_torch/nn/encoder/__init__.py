from .ctan import CTAN, CTANMemoryState, ctan_memory_init, ctan_memory_update

__all__ = ["CTAN", "CTANMemoryState", "ctan_memory_init", "ctan_memory_update"]
