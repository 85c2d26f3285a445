"""The ``bin`` fault of each driver, ``hooks/<driver>.py`` with
``bin(patch)``: one histogram bin altered where that driver's path makes
it (perfbench/tests/faults.py)."""
