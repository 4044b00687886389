"""Live serving plane of the port (counterpart of ``repro/serving``)."""
