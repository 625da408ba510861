from repro_torch.data.bank import stack_workloads
from repro_torch.data.grid_signals import (
    load_signal_csv,
    synth_grid_trace,
    write_signal_csv,
)
from repro_torch.data.synth_trace import synth_workload
from repro_torch.data.trace_io import load_supercloud, write_supercloud_csvs
from repro_torch.data.validate import IngestionReport, validate_jobs
