"""Entry points: the serve front (``serve``) and its step builders (``steps``)."""
