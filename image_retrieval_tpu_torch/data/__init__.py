"""Host decode loader (framework-free)."""
