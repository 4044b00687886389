"""Models served by the port (counterpart of ``repro/models``)."""
