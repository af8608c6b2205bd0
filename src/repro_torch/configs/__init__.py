# One module per architecture: ``config()`` (the published numbers) and
# ``reduced()`` (a same-family miniature for CPU tests); see ``config.py``.
