"""DSP: exact magnitude, preamble/DF17 detection, packed PPM compares."""
