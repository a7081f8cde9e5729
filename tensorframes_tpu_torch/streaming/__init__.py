"""Out-of-core support: the disk spill store (``spill.py``).  The windowed
reader, sinks and streamed verbs of the JAX package's ``streaming/`` wait
for ROADMAP.md Queue 1 item 11."""
