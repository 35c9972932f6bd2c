"""Aircraft state: the ICAO acceptance cache of the extended decode."""
