"""Mode S protocol: CRC-24 and single-bit repair."""
