"""Launch layer (counterpart of ``repro/launch``): meshes (``mesh``), the
sharding policy (``sharding``), meta-device specs of every cell
(``specs``), the step builders (``steps``), the training driver
(``train``) and the live serving driver (``serve``)."""
