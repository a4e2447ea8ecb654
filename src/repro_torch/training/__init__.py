"""The LM substrate's steps: serving so far (prefill and greedy decode)."""
