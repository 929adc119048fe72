from .metrics import mrr, mrr_per_edge, mrr_sum_count

__all__ = ["mrr", "mrr_per_edge", "mrr_sum_count"]
