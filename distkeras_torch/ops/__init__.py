"""Attention ops of the serving path: each a hand-written Hopper kernel
with its plain PyTorch version beside it (:mod:`.paged_attention`,
:mod:`.splash_prefill`)."""
