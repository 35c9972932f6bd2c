"""Mode S protocol: CRC-24 and repair, the short-frame CRC and frame makers,
and the host packet model (packets, ACAS, Comm-B)."""
