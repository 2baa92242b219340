"""Host milliseconds of a refresh's copy of the table to the host and
its swap into the row cache: the port's ``serve.refresh_store`` span
(median over the run's refreshes)."""
import statistics

from gnnbench import spans


def read(obs):
    got = [e["dur"] / 1e3 for e in spans.program_spans()
           if e["name"] == "serve.refresh_store"]
    return statistics.median(got) if got else None
