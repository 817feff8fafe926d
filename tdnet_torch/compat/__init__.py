"""Foreign weight formats: the counterpart of ``tdnet/compat/``."""
