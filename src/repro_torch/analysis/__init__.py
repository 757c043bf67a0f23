"""repro_torch.analysis — the runtime sanitizer (``REPRO_SANITIZE=1``).

:mod:`repro_torch.analysis.sanitizer` is a copy of ``repro``'s and wraps
the port's SubstrateEngine and InstancePool with the same conservation,
heap-consistency, telemetry-immutability and NaN/inf checks. The static
checker (``repro.analysis.lint``) lints ``src/``, this package included, and
is not copied.
"""
