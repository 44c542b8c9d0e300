"""Host utilities: text and metric loggers, parameter fingerprints."""
