from .metrics import binary_accuracy, mrr, mrr_per_edge, mrr_sum_count, mse, ndcg_at_k

__all__ = ["binary_accuracy", "mrr", "mrr_per_edge", "mrr_sum_count", "mse", "ndcg_at_k"]
