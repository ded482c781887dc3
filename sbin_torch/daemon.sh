#!/usr/bin/env bash
# Start, stop or query one apsim_tpu_torch similarity server as a daemon:
# `python3 -m apsim_tpu_torch.cli serve` on the card (the PyTorch port's
# counterpart of sbin/daemon.sh).  Runs from any working directory without
# an install: PYTHONPATH is set to this checkout.
#
# Usage: daemon.sh (start|stop|status) [serve args...]
#   APSIM_PYTHON         interpreter             (default python3)
#   APSIM_PID_DIR        PID file directory      (default /tmp/apsim)
#   APSIM_LOG_DIR        server log directory    (default <checkout>/logs)
#   APSIM_START_TIMEOUT  seconds start waits for the server to be up (120)
#   APSIM_STOP_TIMEOUT   seconds stop waits for it to exit (60)
#
# start returns once the log shows "serving on HOST:PORT" (a follower rank
# of a replicated cluster: "follower: replaying op log").  If the server
# exits first, start prints the log's tail, removes the PID file and exits
# 1: the server runs on the card unless the serve args say --device cpu,
# and nothing falls back to the CPU.
# stop sends SIGINT, the signal serve handles: it closes the RPC server and
# writes the final checkpoint (--checkpoint-dir).  A server still running
# APSIM_STOP_TIMEOUT seconds later is killed, and stop exits 1.
set -euo pipefail

APSIM_HOME="$(cd "$(dirname "$0")/.." && pwd)"
PYTHON="${APSIM_PYTHON:-python3}"
PID_DIR="${APSIM_PID_DIR:-/tmp/apsim}"
LOG_DIR="${APSIM_LOG_DIR:-$APSIM_HOME/logs}"
START_TIMEOUT="${APSIM_START_TIMEOUT:-120}"
STOP_TIMEOUT="${APSIM_STOP_TIMEOUT:-60}"
PID_FILE="$PID_DIR/apsim-torch-server.pid"
LOG_FILE="$LOG_DIR/apsim-torch-server.out"
mkdir -p "$PID_DIR" "$LOG_DIR"

# true while process $1 runs; a zombie counts as gone, since its parent
# (init, once this script has exited) may never reap it
alive() {
  kill -0 "$1" 2>/dev/null &&
    ! grep -q '^State:[[:space:]]*Z' "/proc/$1/status" 2>/dev/null
}

# true while the PID file names a live server of this package (a PID the
# system has since given to another program does not count)
running() {
  local pid
  [[ -f "$PID_FILE" ]] || return 1
  pid="$(cat "$PID_FILE")"
  alive "$pid" &&
    [[ "$(tr '\0' ' ' < "/proc/$pid/cmdline" 2>/dev/null)" == \
      *"apsim_tpu_torch.cli serve"* ]]
}

cmd="${1:-}"; shift || true

case "$cmd" in
  start)
    if running; then
      echo "apsim-torch server already running (pid $(cat "$PID_FILE"))"
      exit 0
    fi
    : > "$LOG_FILE"  # an old log's "serving on" must not count as this start
    PYTHONPATH="$APSIM_HOME${PYTHONPATH:+:$PYTHONPATH}" nohup "$PYTHON" \
      -m apsim_tpu_torch.cli serve "$@" < /dev/null >> "$LOG_FILE" 2>&1 &
    pid=$!
    echo "$pid" > "$PID_FILE"
    deadline=$((SECONDS + START_TIMEOUT))
    until grep -qE '^(serving on |follower: replaying op log)' "$LOG_FILE"; do
      if ! alive "$pid"; then
        rc=0
        wait "$pid" || rc=$?
        rm -f "$PID_FILE"
        echo "apsim-torch server exited (status $rc) before it was up;" \
          "the end of $LOG_FILE:" >&2
        tail -n 40 "$LOG_FILE" >&2
        exit 1
      fi
      if (( SECONDS >= deadline )); then
        kill -KILL "$pid" 2>/dev/null || true
        rm -f "$PID_FILE"
        echo "apsim-torch server not up after ${START_TIMEOUT} s; killed" \
          "it; the end of $LOG_FILE:" >&2
        tail -n 40 "$LOG_FILE" >&2
        exit 1
      fi
      sleep 0.2
    done
    echo "started apsim-torch server pid $pid," \
      "$(grep -m 1 -E '^(serving on |follower: )' "$LOG_FILE"), log $LOG_FILE"
    ;;
  stop)
    if ! running; then
      rm -f "$PID_FILE"
      echo "not running"
      exit 0
    fi
    pid="$(cat "$PID_FILE")"
    kill -INT "$pid" 2>/dev/null || true  # it may have exited meanwhile
    deadline=$((SECONDS + STOP_TIMEOUT))
    while alive "$pid"; do
      if (( SECONDS >= deadline )); then
        kill -KILL "$pid" 2>/dev/null || true
        rm -f "$PID_FILE"
        echo "apsim-torch server pid $pid still running ${STOP_TIMEOUT} s" \
          "after SIGINT; killed it: its final checkpoint may be missing" >&2
        exit 1
      fi
      sleep 0.2
    done
    rm -f "$PID_FILE"
    echo "stopped"
    ;;
  status)
    if running; then
      echo "running (pid $(cat "$PID_FILE"))"
    else
      echo "stopped"
    fi
    ;;
  *)
    echo "usage: $0 (start|stop|status) [serve args...]" >&2
    exit 1
    ;;
esac
