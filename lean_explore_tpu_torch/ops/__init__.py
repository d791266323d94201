"""Retrieval ops: dense top-k and the hand-written bin_topk kernel."""
