"""User tools of the port: corpus preparation (``prepare_data``) and
one-file inference from a run directory (``inference``)."""
