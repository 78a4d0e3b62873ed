"""The loads, one module a traffic ``kind``: ``train`` and
``serve_closed_loop``."""
