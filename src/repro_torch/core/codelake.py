"""Code Lake (paper §III step 2): a retrieval corpus of COULER snippets.

Each entry is (description, code template). Templates use {slot} holes
filled from entities extracted out of the NL subtask ("{models}", "{count}",
"{dataset}", "{metric}"). Generated programs exec against
``repro_torch.core.api`` to build a real WorkflowIR — the pass@k grader runs them.
"""

SNIPPETS = [
    ("task: load. load data from the dataset into the pipeline ingest read input",
     "data = couler.run_step(steps.load_data, {dataset}, step_name='load-data')\n"),

    ("task: preprocess. preprocess clean transform normalize the raw data tokenize features",
     "prep = couler.run_step(steps.preprocess, data, step_name='preprocess')\n"),

    ("task: augment. augment the training data with transformations",
     "aug = couler.run_step(steps.augment, prep, step_name='augment')\n"),

    ("task: split. split the data into train and validation test sets",
     "splits = couler.run_step(steps.split_data, prep, step_name='split-data')\n"),

    ("task: train. train a single model on the training data fit",
     "trained = couler.run_step(steps.train_model, prep, {models}[0],"
     " step_name='train')\n"),

    ("task: train_multi. train each candidate model apply multiple models resnet vit densenet "
     "lstm xgboost lightgbm on the same training data",
     "trained = couler.map_(lambda m: couler.run_step(steps.train_model,"
     " prep, m, step_name='train-' + m), {models})\n"),

    ("task: evaluate. evaluate validate each trained model on the validation data compute "
     "metrics",
     "evals = couler.map_(lambda t: couler.run_step(steps.evaluate, t,"
     " {metric}, step_name='eval-' + t.job_name), trained)\n"),

    ("task: select. compare models and select choose the best one by metric",
     "best = couler.run_step(steps.select_best, *evals,"
     " step_name='select-best')\n"),

    ("task: deploy. deploy push the selected best model to serving if it passes the "
     "quality gate threshold",
     "couler.when(couler.equal(best, True),\n"
     "    lambda: couler.run_step(steps.deploy, best, step_name='deploy'))\n"),

    ("task: report. generate produce a prediction report summary of the results",
     "report = couler.run_step(steps.report, best, step_name='report')\n"),

    ("task: tune. tune hyperparameters search over learning rates batch sizes",
     "tuned = couler.map_(lambda h: couler.run_step(steps.train_model,"
     " prep, h, step_name='hp-' + str(h)), steps.hp_grid({count}))\n"),

    ("task: concurrent. run two training jobs concurrently in parallel xgboost lightgbm automl",
     "couler.concurrent([lambda: couler.run_step(steps.train_model, prep,"
     " {models}[0], step_name='train-a'),\n"
     "    lambda: couler.run_step(steps.train_model, prep, {models}[-1],"
     " step_name='train-b')])\n"),

    ("task: loop. retry keep flipping run repeatedly until the condition is met "
     "converges",
     "res = couler.run_step(steps.check, prep, step_name='check')\n"
     "couler.exec_while(couler.equal(res, False),"
     " lambda: couler.run_step(steps.check, prep, step_name='check'))\n"),

    ("task: checkpoint. checkpoint save the model weights to storage",
     "ckpt = couler.run_step(steps.save_checkpoint, trained,"
     " step_name='checkpoint')\n"),

    ("task: train finetune. fine tune finetune a pretrained language model on the corpus",
     "trained = couler.run_step(steps.finetune, prep, {models}[0],"
     " step_name='finetune')\n"),
]
