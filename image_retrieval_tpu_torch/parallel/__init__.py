"""Search collectives (one device so far; multi-device: ROADMAP.md queue 1)."""
