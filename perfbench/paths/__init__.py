"""Path adapters: each module names the program's entry a cell drives
(``entry``), the outputs it returns (``OUTPUTS``) and the reference that
judges them (``REFERENCE``, a module of ``perfbench/reference/``)."""
