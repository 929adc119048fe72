from .metrics import mrr, mrr_per_edge, mrr_sum_count, ndcg_at_k

__all__ = ["mrr", "mrr_per_edge", "mrr_sum_count", "ndcg_at_k"]
