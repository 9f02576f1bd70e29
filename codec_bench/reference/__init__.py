"""The plain reference that decides ``correct``: the standard library's
zlib, which shares no code with the program under test.

It is handed the inputs the benchmark made (compressed streams, payloads)
and the program's outputs, and works out everything else itself.  It
imports nothing of the program.
"""
