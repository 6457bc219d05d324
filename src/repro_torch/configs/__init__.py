"""Configs of the port. Only the paper's own pipeline is here: the language
model configs of ``repro/configs/`` come with the model slice (ROADMAP.md,
Queue 1 item 8)."""
