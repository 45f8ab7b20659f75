"""Host-side pieces of the cycle engine, numpy copies of the reference's
modules at the same paths: the trace layer (``isa``, ``trace``,
``events``, ``interpreter``), the policy constants and victim oracle
(``policies``) and the numpy head of ``simulator`` (machine parameters
and the scalar-core baseline).  The engine that runs the event matrices
comes with the next slice of the port."""
