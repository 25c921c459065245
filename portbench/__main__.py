import time

T_PROCESS = time.perf_counter()


def _process_age_s() -> float:
    """Seconds since this process started (Linux /proc), 0 elsewhere."""
    import os

    try:
        with open("/proc/self/stat") as fh:
            start_ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


if __name__ == "__main__":
    import sys

    from portbench.run import main

    sys.exit(main(sys.argv[1:], t_process=T_PROCESS - _process_age_s()))
