"""Live invariant checks of the service's counter streams (the port's copy
of what ``repro.analysis`` gives the live service; the offline auditor
``repro.analysis.streams.audit_state_dir`` reads port-written state dirs
as they are, since the on-disk format is the same)."""
