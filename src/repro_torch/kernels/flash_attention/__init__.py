"""Flash-attention forward (causal, sliding window, GQA) for Hopper."""
