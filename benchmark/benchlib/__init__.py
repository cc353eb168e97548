"""The benchmark's own library: the yardstick that later changes to the
program cannot touch.  It imports nothing of the program at import time;
``jobs/`` drive the program, everything here measures and judges it."""
