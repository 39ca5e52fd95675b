"""Launch helpers (``repro.launch``).  Only the serve CLI's synthetic
drift hook is ported so far; the CLIs are ROADMAP queue 1 item 11."""
