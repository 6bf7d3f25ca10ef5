"""Example drivers of the port (``python -m repro_torch.examples.<name>``),
each the counterpart of the reference's ``examples/<name>.py`` with the
same flags, defaults and printed lines, and a ``--device`` (``cuda`` unless
the caller asks for ``cpu``) where it touches a device."""
