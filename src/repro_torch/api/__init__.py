"""The workload API, cut to the jobs the port runs: ``ServeJob`` with
replicas behind the router and ``RLJob`` (``resources``), and their
drivers (``runners``).  Import the submodules directly."""
