"""Evaluation: perplexity (eval.ppl)."""
