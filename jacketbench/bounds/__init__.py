"""The least time the H100 could take for a kernel's work: operations and
bytes counted from shapes, against the published peaks (``peaks.py``)."""
