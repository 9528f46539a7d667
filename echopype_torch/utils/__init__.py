from . import align, compute, coding, io, log, misc, prov, uwa  # noqa: F401
