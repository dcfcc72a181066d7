"""NCBI reference-library downloader (reference scripts/krakenuniq-download).

Supports the same target patterns as the reference Perl downloader
(krakenuniq-download:264-316): `taxonomy`, `contaminants` (UniVec/EmVec),
`viral-neighbors`, `refseq/DOMAINS[/ASSEMBLY_LEVELS[/COL=VAL]*]`,
`genbank/DOMAINS[...]` (comma-separated domain and level lists fan out,
krakenuniq-download:269-279), e-utilities searches/accession fetches
(`nucleotide`/`assembly`/`genome` with --search/--ac,
krakenuniq-download:284-305), and `nt`/`microbial-nt` subsets filtered to
a taxa allowlist via the NCBI accession2taxid maps
(krakenuniq-download:889-1076). Downloads are restartable: existing
outputs are skipped unless `overwrite` is set. Assembly fetches run in a
thread pool when `threads` > 1 (the counterpart of the reference's fork
pool, krakenuniq-download:389-417).

The network layer is injectable (`fetch: url -> bytes`) so the pipeline is
fully testable offline; the default uses urllib over https.
"""

from __future__ import annotations

import gzip
import os
import re
import sys
from typing import Callable, Iterable

NCBI_FTP = "https://ftp.ncbi.nlm.nih.gov"
EUTILS = "https://eutils.ncbi.nlm.nih.gov/entrez/eutils"
UNIVEC_URL = f"{NCBI_FTP}/pub/UniVec/UniVec"
EMVEC_URL = "https://ftp.ebi.ac.uk/pub/databases/emvec/emvec.dat.gz"
TAXDUMP_URL = f"{NCBI_FTP}/pub/taxonomy/taxdump.tar.gz"

TID_SYNTHETIC = 32630  # 'synthetic construct' (UniVec)
TID_ARTIFICIAL = 81077  # 'artificial sequences' (EmVec)

# refseq/genbank domain directories the reference accepts
DOMAINS = {
    "archaea",
    "bacteria",
    "fungi",
    "invertebrate",
    "plant",
    "protozoa",
    "vertebrate_mammalian",
    "vertebrate_other",
    "viral",
    "mitochondrion",
    "plasmid",
    "plastid",
    "human",
}

VIRAL_NEIGHBORS_TERM = (
    '"viruses"[Organism] AND srcdb_genbank[Properties] '
    "NOT wgs[PROP] NOT cellular organisms[ORGN] "
    'AND nuccore genome samespecies[Filter] NOT "sequence from type"[Filter]'
)

KRAKEN_PREFIX = "kraken:taxid|"
EFETCH_BATCH = 10_000
NT_URL = f"{NCBI_FTP}/blast/db/FASTA/nt.gz"
ACCESSION2TAXID = f"{NCBI_FTP}/pub/taxonomy/accession2taxid"

# nt taxa divisions -> NCBI root taxids (krakenuniq-download:80-135; the
# reference credits kaiju's taxonlist.tsv). Required byte-compatible data
# constants, not code.
DIVISION_TO_TAXIDS = {
    "bacteria": [2],
    "archaea": [2157],
    "viral": [10239, 12884],
    "fungi": [4751],
    "protozoa": [
        33630, 554915, 554296, 1401294, 193537, 3041, 28009, 190322, 3027,
        33682, 207245, 38254, 2830, 5752, 556282, 339960, 136087, 66288,
        759891, 5719, 419944, 543769, 2763, 33634, 589438, 137418, 1084709,
    ],
    "parasitic_worms": [6199, 6178, 37945, 10232, 6231],
}
NT_DEFAULT_TAXA = "bacteria,archaea,viral,fungi,protozoa"  # krakenuniq-download:138


def _default_fetch(url: str) -> bytes:
    import urllib.request

    req = urllib.request.Request(url, headers={"User-Agent": "krakenuniq-tpu-torch"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.read()


def _maybe_gunzip(data: bytes) -> bytes:
    if data[:2] == b"\x1f\x8b":
        return gzip.decompress(data)
    return data


def filter_fasta(
    data: bytes, taxid: int, min_seq_len: int = 0
) -> tuple[bytes, list[tuple[str, int]]]:
    """Filter a FASTA byte blob by minimum sequence length and derive its
    seqid->taxid mapping.

    The mapping taxid is `taxid` unless the header uses the
    `kraken:taxid|NNN|...` convention (set_lcas.cpp:314-323), which wins."""
    out: list[bytes] = []
    mapping: list[tuple[str, int]] = []
    header: bytes | None = None
    chunks: list[bytes] = []

    def flush():
        if header is None:
            return
        seq = b"".join(chunks)
        if min_seq_len and len(seq) < min_seq_len:
            return
        seqid = header[1:].split()[0].decode()
        t = taxid
        if seqid.startswith(KRAKEN_PREFIX):
            m = re.match(r"\d+", seqid[len(KRAKEN_PREFIX) :])
            if m:
                t = int(m.group())
        mapping.append((seqid, t))
        out.append(header + b"\n" + seq + b"\n")

    for line in data.splitlines():
        if line.startswith(b">"):
            flush()
            header = line
            chunks = []
        elif header is not None:
            chunks.append(line.strip())
    flush()
    return b"".join(out), mapping


class Downloader:
    def __init__(
        self,
        db_dir: str,
        fetch: Callable[[str], bytes] | None = None,
        overwrite: bool = False,
        dust: bool = False,
        min_seq_len: int = 0,
        verbose: bool = True,
        threads: int = 1,
        taxa: str | None = None,
        exclude_environmental_taxa: bool = False,
    ):
        self.db_dir = db_dir
        self.fetch = fetch or _default_fetch
        self.overwrite = overwrite
        self.dust = dust
        self.min_seq_len = min_seq_len
        self.verbose = verbose
        self.threads = max(1, int(threads))
        self.taxa = taxa or NT_DEFAULT_TAXA
        self.exclude_environmental_taxa = exclude_environmental_taxa
        self._warned_dust = False

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg, file=sys.stderr)

    def _lib_dir(self, name: str) -> str:
        d = os.path.join(self.db_dir, "library", name)
        os.makedirs(d, exist_ok=True)
        return d

    def _dustmask(self, fasta: bytes) -> bytes:
        """Mask low-complexity regions with dustmasker when available
        (the reference shells out to it too, krakenuniq-download)."""
        import shutil
        import subprocess

        exe = shutil.which("dustmasker")
        if exe is None:
            if not self._warned_dust:
                self._log("dustmasker not found; skipping low-complexity masking")
                self._warned_dust = True
            return fasta
        proc = subprocess.run(
            [exe, "-outfmt", "fasta"], input=fasta, capture_output=True, check=True
        )
        # dustmasker lowercases masked regions; the reference turns them to N
        out = []
        for line in proc.stdout.splitlines(keepends=True):
            if line.startswith(b">"):
                out.append(line)
            else:
                out.append(re.sub(rb"[acgt]", b"N", line))
        return b"".join(out)

    def _write_library_file(
        self, lib: str, stem: str, fasta: bytes, taxid: int
    ) -> bool:
        d = self._lib_dir(lib)
        fna = os.path.join(d, stem + ".fna")
        if os.path.exists(fna) and not self.overwrite:
            return False
        filtered, mapping = filter_fasta(fasta, taxid, self.min_seq_len)
        if self.dust:
            filtered = self._dustmask(filtered)
        with open(fna, "wb") as f:
            f.write(filtered)
        with open(os.path.join(d, stem + ".map"), "w") as f:
            for seqid, t in mapping:
                if t:
                    f.write(f"{seqid}\t{t}\n")
        return True

    # ---- patterns ----------------------------------------------------------

    def download(self, pattern: str) -> None:
        if pattern == "taxonomy":
            self.download_taxonomy()
        elif pattern == "contaminants":
            self.download_contaminants()
        elif pattern == "viral-neighbors":
            self.download_search("viral-neighbors", VIRAL_NEIGHBORS_TERM)
        elif pattern in ("nt", "microbial-nt"):
            # both run the same taxa-filtered nt path; the taxa list (or its
            # microbial default) is what distinguishes the subsets
            # (krakenuniq-download:306-308)
            self.download_taxonomy()
            self.download_nt()
        elif pattern.startswith(("refseq/", "genbank/")) or pattern in (
            "refseq",
            "genbank",
        ):
            self.download_assemblies(pattern)
        else:
            raise ValueError(f"unknown download pattern: {pattern!r}")

    def download_taxonomy(self) -> None:
        tax_dir = os.path.join(self.db_dir, "taxonomy")
        nodes = os.path.join(tax_dir, "nodes.dmp")
        names = os.path.join(tax_dir, "names.dmp")
        if os.path.exists(nodes) and os.path.exists(names) and not self.overwrite:
            self._log("taxonomy present, skipping")
            return
        os.makedirs(tax_dir, exist_ok=True)
        self._log(f"fetching {TAXDUMP_URL}")
        data = self.fetch(TAXDUMP_URL)
        import io
        import tarfile

        with tarfile.open(fileobj=io.BytesIO(data), mode="r:*") as tar:
            for member in tar.getmembers():
                base = os.path.basename(member.name)
                if base in ("nodes.dmp", "names.dmp", "merged.dmp", "delnodes.dmp"):
                    src = tar.extractfile(member)
                    if src is not None:
                        with open(os.path.join(tax_dir, base), "wb") as dst:
                            dst.write(src.read())

    def download_contaminants(self) -> None:
        univec = self.fetch(UNIVEC_URL)
        self._write_library_file("contaminants", "UniVec", univec, TID_SYNTHETIC)
        try:
            emvec = _maybe_gunzip(self.fetch(EMVEC_URL))
        except OSError as e:
            self._log(f"EmVec fetch failed ({e}); continuing with UniVec only")
            return
        if emvec.startswith(b">"):
            fasta = emvec
        else:
            fasta = _embl_to_fasta(emvec)
        self._write_library_file("contaminants", "EmVec", fasta, TID_ARTIFICIAL)

    def download_assemblies(
        self,
        pattern: str,
        fna_types: str = "genomic",
        default_domains: str | None = None,
        default_level: str | None = "Complete_Genome",
        category: str | None = None,
    ) -> int:
        """`refseq/DOMAINS[/ASSEMBLY_LEVELS[/COL=VAL]*]` (or genbank/...).

        DOMAINS and ASSEMBLY_LEVELS are comma-separated lists fanned out
        like the reference's nested split loops (krakenuniq-download:
        269-279). ASSEMBLY_LEVEL values: Complete_Genome, Chromosome,
        Scaffold, Contig, or Any. COL=VAL filters match
        assembly_summary.txt columns exactly. `default_domains` /
        `default_level` fill parts the pattern omits (the --domain /
        --assembly-level flags, krakenuniq-download:271-272); `category`
        adds a refseq_category column match (--category,
        krakenuniq-download:1204).

        As in KrakenUniq, the level defaults to Complete_Genome
        (krakenuniq-download:51), and a pattern that names no domain, with
        no default domain, fetches nothing (the JAX package takes Any and
        bacteria there)."""
        parts = pattern.split("/")
        section = parts[0]
        domains = parts[1] if len(parts) > 1 and parts[1] else default_domains
        if section not in ("refseq", "genbank"):
            raise ValueError(f"bad section {section!r}")
        if not domains:
            print(
                f"{pattern}: no domain given (in the pattern or by --domain); "
                "nothing downloaded",
                file=sys.stderr,
            )
            return 0
        levels: list[str | None] = [None]
        col_filters: list[tuple[str, str]] = []
        extras = list(parts[2:])
        if extras and "=" not in extras[0]:
            levels = [
                None if lv == "Any" else lv.replace("_", " ")
                for lv in extras.pop(0).split(",")
            ]
        elif default_level:
            levels = [
                None if lv == "Any" else lv.replace("_", " ")
                for lv in default_level.split(",")
            ]
        for extra in extras:
            if "=" not in extra:
                raise ValueError(f"bad assembly filter {extra!r} (expected COL=VAL)")
            col, val = extra.split("=", 1)
            col_filters.append((col, val))
        if category:
            col_filters.append(("refseq_category", category))
        n = 0
        for domain in domains.split(","):
            if domain not in DOMAINS:
                raise ValueError(
                    f"unknown domain {domain!r}; expected one of {sorted(DOMAINS)}"
                )
            for level in levels:
                n += self._download_domain(
                    section, domain, level, col_filters, fna_types
                )
        self._log(f"{pattern}: {n} assemblies")
        return n

    def _download_domain(
        self,
        section: str,
        domain: str,
        level: str | None,
        col_filters: list,
        fna_types: str,
    ) -> int:
        """One (section, domain, assembly-level) summary pass; assembly
        fetches run through the thread pool when threads > 1
        (krakenuniq-download:389-417's fork pool, threaded)."""
        url = f"{NCBI_FTP}/genomes/{section}/{domain}/assembly_summary.txt"
        self._log(f"fetching {url}")
        summary = self.fetch(url).decode("utf-8", "replace")
        header: list[str] = []
        jobs: list[tuple[str, str, int]] = []  # (ftp_path, base, taxid)
        for line in summary.splitlines():
            if line.startswith("#"):
                if "assembly_accession" in line:
                    header = line.lstrip("# ").rstrip("\n").split("\t")
                continue
            if not header or not line.strip():
                continue
            row = dict(zip(header, line.split("\t")))
            if level and row.get("assembly_level") != level:
                continue
            if row.get("version_status", "latest") != "latest":
                continue
            if any(row.get(c) != v for c, v in col_filters):
                continue
            ftp_path = row.get("ftp_path", "")
            if not ftp_path or ftp_path == "na":
                continue
            base = ftp_path.rstrip("/").rsplit("/", 1)[-1]
            jobs.append((ftp_path, base, int(row.get("taxid") or 0)))

        def fetch_one(job) -> bool:
            ftp_path, base, taxid = job
            got_any = False
            for fna_type in fna_types.split(","):
                stem = f"{base}_{fna_type}"
                d = self._lib_dir(domain)
                if os.path.exists(os.path.join(d, stem + ".fna")) and not self.overwrite:
                    got_any = True
                    continue
                file_url = f"{ftp_path}/{stem}.fna.gz"
                self._log(f"fetching {file_url}")
                try:
                    fasta = _maybe_gunzip(self.fetch(file_url))
                except OSError as e:
                    self._log(f"  failed: {e}")
                    continue
                self._write_library_file(domain, stem, fasta, taxid)
                got_any = True
            return got_any

        if self.threads > 1 and len(jobs) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=self.threads) as pool:
                results = list(pool.map(fetch_one, jobs))
        else:
            results = [fetch_one(j) for j in jobs]
        return sum(bool(r) for r in results)

    # ---- e-utilities -------------------------------------------------------

    def download_search(
        self,
        name: str,
        term: str,
        retmode: str = "text",
        rettype: str = "fasta",
        db: str = "nuccore",
    ) -> int:
        """esearch (usehistory) + batched efetch; writes library/NAME/NAME.i.fna.
        Returns the number of fetched batches. `db` selects the e-utilities
        database -- nuccore for `nucleotide`/`viral-neighbors`, or the
        `assembly`/`genome` databases (krakenuniq-download:284-290)."""
        from urllib.parse import quote

        url = (
            f"{EUTILS}/esearch.fcgi?db={db}&usehistory=y&retmax=0"
            f"&term={quote(term)}"
        )
        self._log(f"esearch [{db}]: {term}")
        xml = self.fetch(url).decode("utf-8", "replace")

        def tag(t: str) -> str:
            m = re.search(rf"<{t}>([^<]*)</{t}>", xml)
            if not m:
                raise OSError(f"esearch response missing <{t}>")
            return m.group(1)

        count = int(tag("Count"))
        query_key = tag("QueryKey")
        webenv = tag("WebEnv")
        self._log(f"  {count} records")
        batches = 0
        for start in range(0, count, EFETCH_BATCH):
            i = start // EFETCH_BATCH
            d = self._lib_dir(name)
            out = os.path.join(d, f"{name}.{i}.fna")
            if os.path.exists(out) and not self.overwrite:
                batches += 1
                continue
            fetch_url = (
                f"{EUTILS}/efetch.fcgi?db={db}&query_key={query_key}"
                f"&WebEnv={quote(webenv)}&retstart={start}&retmax={EFETCH_BATCH}"
                f"&rettype={rettype}&retmode={retmode}"
            )
            data = _maybe_gunzip(self.fetch(fetch_url))
            filtered, mapping = filter_fasta(data, 0, self.min_seq_len)
            if self.dust:
                filtered = self._dustmask(filtered)
            with open(out, "wb") as f:
                f.write(filtered)
            with open(os.path.join(d, f"{name}.{i}.map"), "w") as f:
                for seqid, t in mapping:
                    if t:
                        f.write(f"{seqid}\t{t}\n")
            batches += 1
        return batches

    def download_eutils_accessions(self, db: str, accessions: Iterable[str]) -> int:
        """`assembly`/`genome`/`nucleotide` accession fetch via a fielded
        esearch (the reference wraps the accession list in a search term,
        krakenuniq-download:295-301: `[Assembly Accession]` for assembly,
        `[Accession]` otherwise)."""
        field = "Assembly Accession" if db == "assembly" else "Accession"
        acs = [a.strip() for a in accessions if a.strip()]
        term = " OR ".join(f"{a}[{field}]" for a in acs)
        ncbi_db = "nuccore" if db == "nucleotide" else db
        return self.download_search(db, term, db=ncbi_db)

    def download_accessions(self, accessions: Iterable[str], rettype: str = "fasta") -> int:
        from urllib.parse import quote

        acs = [a.strip() for a in accessions if a.strip()]
        d = self._lib_dir("nucleotide")
        n = 0
        for i in range(0, len(acs), 100):
            chunk = acs[i : i + 100]
            out = os.path.join(d, f"nucleotide.{i // 100}.fna")
            if os.path.exists(out) and not self.overwrite:
                n += 1
                continue
            url = (
                f"{EUTILS}/efetch.fcgi?db=nuccore&id={quote(','.join(chunk))}"
                f"&rettype={rettype}&retmode=text"
            )
            data = _maybe_gunzip(self.fetch(url))
            filtered, mapping = filter_fasta(data, 0, self.min_seq_len)
            with open(out, "wb") as f:
                f.write(filtered)
            with open(os.path.join(d, f"nucleotide.{i // 100}.map"), "w") as f:
                for seqid, t in mapping:
                    if t:
                        f.write(f"{seqid}\t{t}\n")
            n += 1
        return n


    # ---- nt / microbial-nt -------------------------------------------------

    def download_nt(self) -> None:
        """Taxa-filtered nt subsets (krakenuniq-download:889-1000):
        download the nt FASTA and the NCBI accession2taxid maps, build an
        accession -> byte-offset index over nt's headers, resolve each
        `--taxa` entry (a division name or `taxIDNNN`) to its descendant
        taxid set through nodes.dmp (optionally pruning 'environmental
        samples' subtrees), join the maps against the accepted taxa and the
        index, and write one `library/nt-<entry>.fna` (+ .map) per entry by
        copying the selected records out of nt."""
        base = self.db_dir
        tax_dir = os.path.join(base, "taxonomy")
        lib_dir = os.path.join(base, "library")
        os.makedirs(lib_dir, exist_ok=True)
        nt_path = os.path.join(base, "nt.fna")
        if not os.path.exists(nt_path) or self.overwrite:
            self._log(f"fetching {NT_URL}")
            data = _maybe_gunzip(self.fetch(NT_URL))
            with open(nt_path + ".tmp", "wb") as f:
                f.write(data)
            os.replace(nt_path + ".tmp", nt_path)
        map_paths = []
        for m in ("nucl_gb", "nucl_wgs"):
            url = f"{ACCESSION2TAXID}/{m}.accession2taxid.gz"
            out = os.path.join(tax_dir, f"{m}.accession2taxid.gz")
            if not os.path.exists(out) or self.overwrite:
                self._log(f"fetching {url}")
                os.makedirs(tax_dir, exist_ok=True)
                with open(out + ".tmp", "wb") as f:
                    f.write(self.fetch(url))
                os.replace(out + ".tmp", out)
            map_paths.append(out)

        entries = [t.strip() for t in self.taxa.split(",") if t.strip()]
        outputs = {e: os.path.join(lib_dir, f"nt-{e}.fna") for e in entries}
        todo = [
            e
            for e in entries
            if self.overwrite or not os.path.exists(outputs[e])
        ]
        if not todo:
            self._log("all nt subsets present, skipping")
            return
        ac_index = nt_ac_index(nt_path)
        child_map = read_child_map(os.path.join(tax_dir, "nodes.dmp"))
        env = (
            environmental_taxids(os.path.join(tax_dir, "names.dmp"))
            if self.exclude_environmental_taxa
            else frozenset()
        )
        selected: dict[str, set] = {}
        all_taxa: set = set()
        for e in todo:
            acc = taxa_descendants(child_map, _taxa_entry_roots(e), env)
            selected[e] = acc
            all_taxa |= acc
        self._log(f"accepted {len(all_taxa)} taxa across {len(todo)} entries")
        taxid_to_acs = tax_mappings(map_paths, all_taxa, ac_index)
        with open(nt_path, "rb") as nt:
            for e in todo:
                n_acs = self._write_filtered_nt(
                    nt, selected[e], taxid_to_acs, ac_index, outputs[e]
                )
                self._log(f"wrote {outputs[e]}: {n_acs} sequences")
                if self.dust and n_acs:
                    with open(outputs[e], "rb") as f:
                        masked = self._dustmask(f.read())
                    with open(outputs[e], "wb") as f:
                        f.write(masked)

    def _write_filtered_nt(
        self, nt, accepted: set, taxid_to_acs: dict, ac_index: dict, out_path: str
    ) -> int:
        """Copy the records of every accepted taxon's accessions out of the
        open nt file by header byte-offset, in ascending-taxid order
        (krakenuniq-download:958-986), emitting `ac<TAB>taxid` map lines."""
        n_acs = 0
        with open(out_path + ".tmp", "wb") as new_nt, open(
            out_path + ".map.tmp", "w"
        ) as map_f:
            for taxid in sorted(accepted):
                for ac in taxid_to_acs.get(taxid, ()):
                    n_acs += 1
                    nt.seek(ac_index[ac])
                    first = nt.readline()
                    new_nt.write(first)
                    map_f.write(f"{ac}\t{taxid}\n")
                    while True:
                        line = nt.readline()
                        if not line or line.startswith(b">"):
                            break
                        new_nt.write(line)
        os.replace(out_path + ".tmp", out_path)
        os.replace(out_path + ".map.tmp", out_path + ".map")
        return n_acs


def _taxa_entry_roots(entry: str) -> list[int]:
    """A `--taxa` entry is a division name or `taxIDNNN`
    (krakenuniq-download:939-947)."""
    m = re.match(r"^taxID(\d+)$", entry, re.IGNORECASE)
    if m:
        return [int(m.group(1))]
    if entry in DIVISION_TO_TAXIDS:
        return DIVISION_TO_TAXIDS[entry]
    raise ValueError(
        f"unknown nt division {entry!r}; choose one of "
        f"{sorted(DIVISION_TO_TAXIDS)} or a specific taxID ('taxID12345')"
    )


def read_child_map(nodes_path: str) -> dict:
    """nodes.dmp -> {parent: [children]} (krakenuniq-download:988-1001)."""
    child_map: dict = {}
    with open(nodes_path, "rb") as f:
        for line in f:
            parts = line.split(b"\t|\t")
            if len(parts) < 2:
                continue
            taxid, parent = int(parts[0]), int(parts[1])
            if taxid != parent:
                child_map.setdefault(parent, []).append(taxid)
    return child_map


def environmental_taxids(names_path: str) -> set:
    """Taxids named 'environmental samples' (krakenuniq-download:1003-1018)."""
    env = set()
    with open(names_path, "rb") as f:
        for line in f:
            parts = line.split(b"\t|\t")
            if len(parts) >= 2 and parts[1].strip() == b"environmental samples":
                env.add(int(parts[0]))
    return env


def taxa_descendants(child_map: dict, roots: list, excluded=frozenset()) -> set:
    """Every descendant-or-self of the roots, pruning `excluded` subtrees
    below the roots (krakenuniq-download:1035-1046, iterative)."""
    out: set = set()
    stack = list(roots)
    out.update(stack)
    while stack:
        node = stack.pop()
        for child in child_map.get(node, ()):
            if child in excluded or child in out:
                continue
            out.add(child)
            stack.append(child)
    return out


def nt_ac_index(nt_path: str) -> dict:
    """Byte offset of every `>accession` header in the nt FASTA
    (krakenuniq-download:1020-1033)."""
    index: dict = {}
    pos = 0
    with open(nt_path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                index[line[1:].split(None, 1)[0].decode()] = pos
            pos += len(line)
    return index


def tax_mappings(map_paths: list, accepted: set, ac_index: dict) -> dict:
    """accession2taxid joins (krakenuniq-download:1048-1076): for each map
    row `ac  ac.version  taxid  gi`, keep versioned accessions that are both
    in an accepted taxon and present in nt."""
    taxid_to_acs: dict = {}
    for path in map_paths:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                try:
                    taxid = int(parts[2])
                except ValueError:
                    continue  # header row
                ac = parts[1].decode()
                if taxid in accepted and ac in ac_index:
                    taxid_to_acs.setdefault(taxid, []).append(ac)
    return taxid_to_acs


def _embl_to_fasta(embl: bytes) -> bytes:
    """Minimal EMBL flat-file -> FASTA (EmVec ships as EMBL .dat)."""
    out: list[bytes] = []
    seqid = None
    seq: list[bytes] = []
    for line in embl.splitlines():
        if line.startswith(b"ID"):
            fields = line[2:].strip().split(b";")
            seqid = fields[0].strip().split()[0] if fields and fields[0].strip() else b"emvec"
            seq = []
        elif line.startswith(b"  ") and seqid is not None:
            seq.append(re.sub(rb"[^A-Za-z]", b"", line))
        elif line.startswith(b"//") and seqid is not None:
            out.append(b">" + seqid + b"\n" + b"".join(seq).upper() + b"\n")
            seqid = None
    return b"".join(out)
