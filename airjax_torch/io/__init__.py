"""IO: synthetic IQ and block sources."""
