"""Step builders of the serving path and the live serving driver
(``launch.serve``); counterpart of ``repro/launch``."""
