"""Host-side utilities (timing)."""
