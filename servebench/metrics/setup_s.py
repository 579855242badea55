"""setup_s: the process's start to the first due request, in seconds
(host clock): imports, weights made on the device, engine and server up,
warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
