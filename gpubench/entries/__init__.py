"""The port's entries a traffic mix can drive, one module each, found by
the mix's ``entry``.  A module gives a unit's sizes (``shape``, and
``tokens``, ``prompts`` and ``rows``: its tokens, the requests it
answers, the sequences one kernel call sees), its inputs (``inputs``),
its model FLOPs (``flops``), the program's ``Driver``, the faults a cell
of it can have (``faults``, ``plant``), the check (``check_numbers``:
the numbers of ``NUMBERS``) and the control in the program's place
(``control``).  A new entry is a new module here; nothing else
changes."""
