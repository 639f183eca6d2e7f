"""Host-side helpers without torch: the CLIP BPE tokenizer and the flow
colour wheel."""
