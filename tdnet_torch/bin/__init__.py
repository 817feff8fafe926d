"""Command-line entry points of the port: ``predict``, ``evaluate`` and
``serve`` (the counterparts of ``tdnet/bin/``)."""
