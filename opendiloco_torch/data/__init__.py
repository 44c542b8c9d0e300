"""Host-side data pipeline."""
