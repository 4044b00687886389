"""Step builders of the serving path (counterpart of ``repro/launch``)."""
