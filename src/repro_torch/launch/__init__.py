"""Launch helpers (``repro.launch``).  Only the serve CLI's synthetic
drift hook is ported so far; the CLIs are the serve CLI and training
items of ROADMAP queue 1."""
