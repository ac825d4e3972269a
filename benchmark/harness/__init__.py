"""The benchmark's shared machinery: files and environment (``common``),
the meta-device census of operations and kernel calls (``census``), the
profiled stretch and its reduction (``trace``) and the comparisons that
decide ``correct`` (``compare``)."""
