"""Display sinks."""
