"""Attention ops of the port, each TPU kernel a hand-written Hopper kernel
with its plain PyTorch version beside it: serving (:mod:`.paged_attention`,
:mod:`.splash_prefill`), training (:mod:`.pallas_attention`) and the
ring's pair attention (:mod:`.pallas_pair`, used by
:mod:`.ring_attention`); plus the plain PyTorch ops around them
(:mod:`.flash_attention`, :mod:`.fused_ce`)."""
