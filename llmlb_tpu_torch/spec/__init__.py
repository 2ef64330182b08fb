"""Draft-free speculative decoding for the port's engine: n-gram
(prompt-lookup) drafting, the port's own copy of `llmlb_tpu/spec/`.

A drafter proposes the next K tokens of a row from its own history; the
target model scores all K+1 positions in ONE step over the KV cache (the
extend kernels at T = K+1), and the scheduler accepts the longest prefix of
drafts that match the model's own samples. Every verify step emits 1..K+1
tokens a row, and because the model samples every emitted token itself, a
greedy or seeded stream is the one plain decode gives (on the card up to the
products' rounding: ROADMAP C).

The scheduler's side (the verify step as a CUDA graph key, the acceptance
walk, page rollback, the grammar lookahead) lives in engine/scheduler.py and
engine/decode_graph.py; the K+1-token model step in models/llama.py
`verify_step{,_paged}`.
"""

from llmlb_tpu_torch.spec.drafter import PromptLookupDrafter, SpecConfig

__all__ = ["PromptLookupDrafter", "SpecConfig"]
