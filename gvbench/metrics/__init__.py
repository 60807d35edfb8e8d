"""Per-layer metrics, one module each, found by the metric's name.

Each module's ``read(record)`` takes the traced run's record and returns
the metric's value, or None where the run holds nothing to read.  The
record holds ``spans`` (name -> host seconds of each occurrence, each
ended by a synchronise), ``counters`` (the drivers' counts), ``calls``
(each packed-matrix product call: name, Nw, Mpad, N, M, B), ``traits``
(traits the window completed) and ``trace`` (``yardstick.reduce_trace``:
``window_s``, ``busy_s``, ``product_s``, the breakdown).  A metric is
added as a module here and an entry in ``BENCHMARK.json``; nothing else
changes."""
