"""C-Eval loader entry points (thin wrappers over datasets.mcqa).

A copy of mi_optimize_tpu/datasets/ceval.py."""
from .mcqa import (  # noqa: F401
    CEVAL_TASK2CTG,
    aggregate_categories,
    extract_cot_answer,
    get_fewshot_prefix,
    get_questions,
    get_subject_testset,
    get_subjects,
)


def get_calibrate_ceval(tokenizer, subject="all", nsamples=4, seqlen=2048, **kw):
    from .mcqa import get_calibrate

    return get_calibrate("ceval", tokenizer, subject=subject, nsamples=nsamples,
                         seqlen=seqlen, **kw)
