"""The loops that drive a cell, one a file, named by a traffic mix's
``loop``: ``run(run, cell)`` returns the result's fields."""
