"""Evaluation: perplexity (eval.ppl) and the Benchmark facade (eval.benchmark)."""
