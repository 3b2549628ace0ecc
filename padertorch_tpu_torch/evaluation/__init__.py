from padertorch_tpu_torch.evaluation.metrics import (
    si_sdr, output_si_sdr, input_si_sdr, mir_eval_sdr,
    InputMetrics, OutputMetrics,
)
from padertorch_tpu_torch.evaluation.parallel import (
    split_managed, gather, gather_merged, bcast, is_master, RANK, SIZE,
)
from padertorch_tpu_torch.evaluation.stoi import stoi
from padertorch_tpu_torch.evaluation.ngram_lm import NGramLM
