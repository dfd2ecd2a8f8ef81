"""The plain reference that decides `correct`: frozen copies, in plain
PyTorch, of the arithmetic the served path must reproduce bit for bit.
It imports nothing of the program (hrbench.guard checks its sources on
every run), and takes nothing the program made: it reads the harness's own
input frames and works the flow, the cadence and every output out again."""
