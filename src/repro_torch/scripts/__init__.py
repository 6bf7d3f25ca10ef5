"""Script drivers of the port (``python -m repro_torch.scripts.<name>``),
each the counterpart of the reference's ``scripts/<name>.py`` (``smoke``:
of ``scripts/smoke.sh`` and the non-benchmark stages of ``scripts/ci.sh``),
with the same flags, defaults and printed lines, and a ``--device``
(``cuda`` unless the caller asks for ``cpu``) where it touches a device."""
