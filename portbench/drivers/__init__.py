"""Drivers, one file per kind of job, named by a traffic file's ``driver``:
``run(cell, opts)`` builds the program for the cell, measures its window and
checks its output."""
