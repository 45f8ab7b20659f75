"""Host-side pieces of the cycle engine that the serving slice shares."""
