"""Drivers: what one call of a traffic mix is, found by the name a
traffic file gives (``"driver": "<name>"`` -> ``drivers/<name>.py``).

A driver module has:

* ``NEEDS_MODEL``: whether the calls use a model fitted in set-up;
* ``COMPARED``: the names of the numbers its check compares;
* ``per_call(traffic)``: the runs one record holds (the check samples
  one of them), or None when a record is one answer;
* ``call(calls, seed)``: one public call with seed ``seed``; returns
  ``(units of work, [records])``;
* ``blank(calls, seed)``: the records of a call with no answers in
  them, which the control fills;
* ``fill(ref, record, run)``: the reference's answer, in the precision
  of ``ref``, written into a blank record (the control);
* ``compare(ref, records, picks)``: ``(numbers, notes)`` over the
  sampled answers, against the reference (float64);
* optionally ``field_seeds(calls)``: the seeds of the pairs of fields
  the calls use (by default the run's seed, one pair).

``calls`` is :class:`perfbench.calls.Calls`; ``ref`` is
:class:`perfbench.checks.Reference`.  A new kind of call is a new file
here; the generator, the check and the control stay as they are.
"""
